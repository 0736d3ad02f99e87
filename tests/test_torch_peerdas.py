"""EIP-7594 PeerDAS in the port, on the CPU, against the JAX package.

Tier-1: compute_cells at full size on the two golden blobs (against the
JAX package's cell digests in the golden file) and the zero blob; the
cell-batch challenge bytes against the JAX package's; recovery's
coefficients from 64 and from 128 cells (the blob's polynomial); the
cell-batch verify at n = 2 from the golden proofs (valid, tampered, the zero
blob's cells) and its malformed inputs; recovery's rejections; the entry
points' default device. The live comparisons with the JAX package's
compute_cells and recovery compile 8192-point XLA transforms, which crash
this CPU's XLA compiler now and then under a loaded parallel run, so they
are `slow`.

The golden file tests/data/torch_peerdas_golden.json holds the two blobs'
cell digests and their 128 proofs. The JAX package's own proofs are wrong
(ROADMAP.md F5: its FK20 leaves out the inverse EC-FFT), so the file's
proofs are made from the JAX package's FK20 steps with that inverse put
back, and held against the spec's definition of a cell proof (the quotient
by X^64 - h^64 committed over the monomial SRS, host big-int arithmetic) on
a few cells. Everything that runs FK20 on the CPU is `slow`: the JAX
package takes minutes for its bank and EC-FFTs, the port's plain FK20 as
long, the host definition a minute and a half a cell.
"""

import hashlib
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from constantine_tpu.models.peerdas import PeerDAS as JaxPeerDAS
from constantine_tpu.models.peerdas import get_peerdas as jax_get_peerdas
from constantine_tpu.named.precompute import get_curve as jax_get_curve
from constantine_tpu_torch import convert
from constantine_tpu_torch.models import peerdas
from constantine_tpu_torch.models.peerdas import PeerDAS
from constantine_tpu_torch.models.trusted_setup import KZGSettings, read_monomial_g1
from constantine_tpu_torch.named.precompute import get_curve
from constantine_tpu_torch.utils import refmath as rm
from constantine_tpu_torch.utils.serialization import g1_compress_affine, scalars_from_bytes

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "data" / "torch_peerdas_golden.json"
KZG_GOLDEN = ROOT / "tests" / "data" / "torch_kzg_golden.json"
INF = bytes([0xC0]) + bytes(47)
ZERO_BLOB = bytes(131072)


def dense_blob(seed: int) -> bytes:
    """Same recipe as tests/test_torch_eip4844.py:dense_blob."""
    rng = np.random.default_rng(seed)
    r = get_curve("BLS12_381").r
    return b"".join((int.from_bytes(rng.bytes(32), "big") % r).to_bytes(32, "big")
                    for _ in range(4096))


@pytest.fixture(scope="module")
def das():
    return PeerDAS(KZGSettings(device="cpu"))


@pytest.fixture(scope="module")
def jpd():
    return jax_get_peerdas()


@pytest.fixture(scope="module")
def golden():
    g = json.loads(GOLDEN.read_text())
    commitments = {e["seed"]: bytes.fromhex(e["commitment"])
                   for e in json.loads(KZG_GOLDEN.read_text())["blobs"]}
    out = {}
    for e in g["blobs"]:
        blob = dense_blob(e["seed"])
        assert hashlib.sha256(blob).hexdigest() == e["blob_sha256"]
        out[e["seed"]] = dict(blob=blob, commitment=commitments[e["seed"]],
                              cells_sha256=e["cells_sha256"],
                              proofs=[bytes.fromhex(p) for p in e["proofs"]])
    return out


@pytest.fixture(scope="module")
def cells(das, golden):
    """The port's cells of each golden blob (held against the JAX package's
    in test_compute_cells_matches_reference)."""
    return {seed: das.compute_cells(g["blob"]) for seed, g in golden.items()}


@pytest.mark.parametrize("which", ["dense1", "dense2", "zero"])
def test_compute_cells_matches_reference(das, golden, cells, which):
    """The golden blobs' cells against the JAX package's digests in the
    golden file (test_golden_file_matches_reference_package recomputes them
    with the JAX package); the zero blob's are zero."""
    if which == "zero":
        assert das.compute_cells(ZERO_BLOB) == [bytes(2048)] * 128
    else:
        seed = int(which[-1])
        assert hashlib.sha256(b"".join(cells[seed])).hexdigest() == golden[seed]["cells_sha256"]


def test_compute_cells_rejects_invalid_blobs(das):
    r = get_curve("BLS12_381").r
    assert das.compute_cells(ZERO_BLOB[:-1]) is None
    assert das.compute_cells(r.to_bytes(32, "big") + ZERO_BLOB[32:]) is None


def test_batch_challenge_matches_reference(das):
    """Against the JAX package's transcript code, called on a stand-in that
    holds only what it reads (the curve context), so no JAX PeerDAS context
    is built."""
    jref = SimpleNamespace(ctx=jax_get_curve("BLS12_381"))
    rng = np.random.default_rng(21)
    unique = [rng.bytes(48) for _ in range(3)]
    cidx = [0, 2, 1, 2, 0]
    idx = [int(v) for v in rng.integers(0, 128, size=5)]
    cl = [rng.bytes(2048) for _ in range(5)]
    pf = [rng.bytes(48) for _ in range(5)]
    assert das._batch_challenge(unique, cidx, idx, cl, pf) == \
        JaxPeerDAS._batch_challenge(jref, unique, cidx, idx, cl, pf)


def _recovery_input(cells, count):
    """Every other cell's (indices, limbs, bytes), or all cells shuffled."""
    rng = np.random.default_rng(count)
    idx = [int(i) for i in (range(0, 128, 2) if count == 64 else rng.permutation(128))]
    data = [cells[1][i] for i in idx]
    limbs, ok = scalars_from_bytes(b"".join(data))
    assert ok.all()
    return idx, limbs.reshape(count, 64, 8), data


def _recover(das, idx, limbs):
    return (das._recover_coeffs if len(idx) < 128 else das._cells_to_coeffs_full)(idx, limbs)


@pytest.mark.parametrize("count", [64, 128])
def test_recovery_coefficients_are_the_blobs(das, cells, count):
    """_recover_coeffs (from every other cell) and _cells_to_coeffs_full
    (all cells, shuffled) give the blob's polynomial, with a zero top half."""
    idx, limbs, _ = _recovery_input(cells, count)
    got = _recover(das, idx, limbs)
    assert not got[4096:].any()
    assert torch.equal(got[:4096], das._blob_to_coeffs(dense_blob(1)))


@pytest.mark.slow
@pytest.mark.parametrize("count", [64, 128])
def test_recovery_coefficients_match_reference(das, jpd, cells, count):
    """The same against the JAX package's (XLA compiles of 8192-point
    transforms: seconds each, and on this CPU they crash the compiler now and
    then under a loaded parallel run)."""
    idx, limbs, data = _recovery_input(cells, count)
    ref_scalars = [jpd._cell_to_scalars(c) for c in data]
    want = (jpd._recover_coeffs if count < 128 else jpd._cells_to_coeffs_full)(idx, ref_scalars)
    assert torch.equal(_recover(das, idx, limbs), convert.from_reference(np.asarray(want)))


def _batch(golden, cells, which):
    """(commitments, indices, cells, proofs) at n = 2."""
    if which == "zero":
        return [INF, INF], [0, 127], [bytes(2048)] * 2, [INF, INF]
    g1, g2 = golden[1], golden[2]
    cl = [cells[1][5], cells[2][100]]
    if which == "tampered":
        bad = bytearray(cl[0])
        bad[100] ^= 1
        cl[0] = bytes(bad)
    return [g1["commitment"], g2["commitment"]], [5, 100], cl, [g1["proofs"][5],
                                                                g2["proofs"][100]]


@pytest.mark.parametrize("which, verdict", [("valid", True), ("tampered", False),
                                            ("zero", True)])
def test_verify_cell_batch(das, golden, cells, which, verdict):
    assert das.verify_cell_kzg_proof_batch(*_batch(golden, cells, which)) is verdict


def test_verify_cell_batch_malformed_is_none(das, golden, cells):
    C, idx, cl, pf = _batch(golden, cells, "valid")
    p = get_curve("BLS12_381").p
    assert das.verify_cell_kzg_proof_batch([], [], [], []) is True
    for args in ((C[:1], idx, cl, pf), (C, [5, 128], cl, pf), (C, idx, [cl[0], cl[1][:-1]], pf),
                 (C, idx, cl, [pf[0], pf[1][:47]]), (C, idx, cl, [pf[0], None]),
                 (C, idx, cl, [bytes([pf[0][0] & 0x7F]) + pf[0][1:], pf[1]]),
                 (C, idx, cl, [pf[0], bytes([0x80 | p.to_bytes(48, "big")[0]])
                               + p.to_bytes(48, "big")[1:]]),
                 (C, idx, [b"\xff" * 32 + cl[0][32:], cl[1]], pf)):
        assert das.verify_cell_kzg_proof_batch(*args) is None


def test_recover_rejects_malformed_and_inconsistent_input(das, cells):
    cl = cells[1]
    half = list(range(0, 128, 2))
    assert das.recover_cells_and_kzg_proofs(half[:-1], [cl[i] for i in half[:-1]]) is None
    assert das.recover_cells_and_kzg_proofs(half, [cl[i] for i in half[:-1]]) is None
    assert das.recover_cells_and_kzg_proofs([0] + half[1:] + [0],
                                            [cl[i] for i in half] + [cl[0]]) is None
    assert das.recover_cells_and_kzg_proofs(half[:-1] + [128], [cl[i] for i in half]) is None
    assert das.recover_cells_and_kzg_proofs(half, [cl[i] for i in half[:-1]]
                                            + [cl[126][:-1]]) is None
    # 65 cells, one changed: no polynomial of degree < 4096 fits them
    bad = [cl[i] for i in half] + [cl[1]]
    bad[3] = bad[3][:64] + bytes(32) + bad[3][96:]
    assert das.recover_cells_and_kzg_proofs(half + [1], bad) is None


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    for call in (lambda: peerdas.compute_cells(ZERO_BLOB),
                 lambda: peerdas.compute_cells_and_kzg_proofs(ZERO_BLOB),
                 lambda: peerdas.verify_cell_kzg_proof_batch([INF], [0], [bytes(2048)], [INF]),
                 lambda: peerdas.recover_cells_and_kzg_proofs([0], [bytes(2048)])):
        with pytest.raises(RuntimeError, match="cuda"):
            call()


# -- slow: everything that runs FK20 on the CPU ------------------------------------------


def reference_fk20_proofs(jpd, blob):
    """128 cell proofs from the JAX package's FK20 steps (its circulant NTT,
    bank, Hadamard scalar multiplication and tree, EC-FFT) with the inverse
    EC-FFT it leaves out put back before the upper half is zeroed."""
    F, g1 = jpd.fr, jpd.ctx.g1
    L, cds = 64, 128
    coeffs = jpd._blob_to_coeffs(blob)
    circ = jnp.take(coeffs, jpd._circ_idx.reshape(-1), axis=0).reshape(L, cds, F.L)
    circ = jnp.where(jpd._circ_mask[..., None], circ, jnp.zeros_like(circ))
    w_canon = F.from_mont(jpd.dom_cds.ntt(circ))
    flat = tuple(b.reshape(L * cds, -1) for b in jpd.bank)
    u = g1.scalar_mul(w_canon.reshape(L * cds, F.L), flat, scalar_bits=255)
    u = tuple(t.reshape((L, cds) + t.shape[1:]) for t in u)
    m = L
    while m > 1:
        h = m // 2
        u = g1.add(tuple(t[:h] for t in u), tuple(t[h:m] for t in u))
        m = h
    hp = jpd.ec_cds.ifft(tuple(t[0] for t in u))
    inf = g1.infinity((cds // 2,))
    hp = tuple(jnp.concatenate([t[:cds // 2], i]) for t, i in zip(hp, inf))
    proofs = tuple(jnp.take(t, jnp.asarray(jpd.brp128), axis=0) for t in jpd.ec_cds.fft(hp))
    (px, py), pinf = g1.to_affine(proofs)
    data = jpd.codec.g1_compress((px, py), np.asarray(pinf))
    return [data[48 * i:48 * (i + 1)] for i in range(cds)]


def spec_cell_proof(coeffs, cell: int, monomial) -> bytes:
    """The spec's cell proof on the host: the quotient of p(X) by X^64 -
    h^64 (h = w_8192^brp7(cell), the cell's coset shift) committed over the
    monomial SRS with python-int point arithmetic."""
    ctx = get_curve("BLS12_381")
    r, p = ctx.r, ctx.p
    brp7 = int(format(cell, "07b")[::-1], 2)
    z = pow(ctx.root_of_unity(13), 64 * brp7, r)
    q = [0] * 4096
    for d in range(4095, 63, -1):
        q[d - 64] = (coeffs[d] + z * q[d]) % r
    acc = None
    for k in range(4032):
        if q[k]:
            acc = rm.ec_add(acc, rm.ec_mul(q[k], monomial[k], 0, p), 0, p)
    return g1_compress_affine(acc)


@pytest.mark.slow
def test_golden_file_matches_reference_package(jpd, golden):
    """Regenerates the golden file's cells and proofs with the JAX package
    (its bank, then the steps of reference_fk20_proofs)."""
    for seed, g in golden.items():
        assert hashlib.sha256(b"".join(jpd.compute_cells(g["blob"]))).hexdigest() == \
            g["cells_sha256"]
        assert reference_fk20_proofs(jpd, g["blob"]) == g["proofs"]


@pytest.mark.slow
def test_golden_proofs_match_the_spec_definition(jpd, golden):
    monomial = read_monomial_g1()
    checked = json.loads(GOLDEN.read_text())["spec_checked_cells"]
    for seed, cells_checked in checked.items():
        g = golden[int(seed)]
        coeffs = jpd.fr.decode(jpd._blob_to_coeffs(g["blob"]))
        for i in cells_checked:
            assert spec_cell_proof(coeffs, i, monomial) == g["proofs"][i]


@pytest.mark.slow
def test_reference_proofs_fail_verification(jpd, golden):
    """F5: the JAX package's compute_cells_and_kzg_proofs gives other proofs,
    which its own verify rejects; it accepts the golden ones."""
    g = golden[1]
    cells, proofs = jpd.compute_cells_and_kzg_proofs(g["blob"])
    assert proofs != g["proofs"]
    idx = [0, 77]
    C = [g["commitment"]] * 2
    assert jpd.verify_cell_kzg_proof_batch(C, idx, [cells[i] for i in idx],
                                           [proofs[i] for i in idx]) is False
    assert jpd.verify_cell_kzg_proof_batch(C, idx, [cells[i] for i in idx],
                                           [g["proofs"][i] for i in idx]) is True


@pytest.mark.slow
def test_port_proofs_and_recovery_on_cpu_match_golden(das, golden, cells):
    g = golden[1]
    got_cells, proofs = das.compute_cells_and_kzg_proofs(g["blob"])
    assert got_cells == cells[1] and proofs == g["proofs"]
    half = list(range(1, 128, 2))
    assert das.recover_cells_and_kzg_proofs(half, [cells[1][i] for i in half]) == \
        (cells[1], g["proofs"])
    z_cells, z_proofs = das.compute_cells_and_kzg_proofs(ZERO_BLOB)
    assert z_cells == [bytes(2048)] * 128 and z_proofs == [INF] * 128


@pytest.mark.slow
def test_reference_verify_agrees_on_golden(jpd, golden, cells):
    for which, verdict in (("valid", True), ("tampered", False), ("zero", True)):
        assert jpd.verify_cell_kzg_proof_batch(*_batch(golden, cells, which)) is verdict
