#!/usr/bin/env python3
"""Host-clock latency of the EIP-4844 and PeerDAS entry points, many calls
each, on one NVIDIA card.

    python3 scripts/torch_path_latency.py

Times, on the EIP-4844 trusted setup and chip_smoke.py's dense blob (seed
1): the fixed-base and the online blob_to_kzg_commitment (K6 once each),
chip_smoke.py's online MSM of 2^16 seeded scalars over table rows (path d,
GLV),
compute_kzg_proof at bench.py's z and verify_kzg_proof of that proof,
verify_blob_kzg_proof_batch of 16 dense blobs (the host glue's field
arithmetic around the kernels), compute_cells (two four-step transforms),
verify_cell_kzg_proof_batch of the blob's 128 cells (K6 twice, the cell
iNTT) and recover_cells_and_kzg_proofs from every other cell (the
four-step, coset and FK20 transforms). Each call ends synchronised; prints the median and
the quartiles in ms, and the K3′, K1 and K6 launches a call. chip_smoke.py
times the same calls 3-5 times, where host noise of 10-40% hides a change
of a few tenths of a ms; run this script from two checkouts in turns
(parent, change, change, parent) to compare them on one card.
"""

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import dense_blob  # noqa: E402
from constantine_tpu_torch import build  # noqa: E402

KERNELS = ("bucket_reduce", "ntt_bfly", "ntt_stages", "mont_mul", "fermat_inv", "miller_loop")


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    build.build_all()
    from constantine_tpu_torch.models import eip4844, peerdas
    from constantine_tpu_torch.models.kzg import get_kzg
    from constantine_tpu_torch.named.precompute import get_curve
    from constantine_tpu_torch.ops.msm import msm
    ctx = get_curve("BLS12_381")
    r = ctx.r
    blob = dense_blob(1, r)
    kzg, kzo = get_kzg("cuda"), get_kzg("cuda", precompute=False)
    das = peerdas.get_peerdas("cuda")
    cells, proofs = peerdas.compute_cells_and_kzg_proofs(blob, das)
    commitment = eip4844.blob_to_kzg_commitment(blob, kzg)
    half = list(range(0, 128, 2))
    z = ((1 << 200) + 12345).to_bytes(32, "big")
    proof, y = eip4844.compute_kzg_proof(blob, z, kzg)
    tabx, taby = kzg._pm._tables
    bases = (tabx[:1 << 16], taby[:1 << 16])
    krng = np.random.default_rng(65536)
    k16 = ctx.scalars_to_limbs([int.from_bytes(krng.bytes(32), "big") % r
                                for _ in range(1 << 16)], "cuda")
    blobs16 = [dense_blob(seed, r) for seed in range(401, 417)]
    coms16 = eip4844.blob_to_kzg_commitment_batch(blobs16, kzg)
    proofs16 = [eip4844.compute_blob_kzg_proof(b, c, kzg) for b, c in zip(blobs16, coms16)]
    calls = (
        ("commit", 30, lambda: eip4844.blob_to_kzg_commitment(blob, kzg)),
        ("online commit", 30, lambda: eip4844.blob_to_kzg_commitment(blob, kzo)),
        ("msm 2^16", 30, lambda: msm(ctx.g1, bases, k16)),
        ("compute_kzg_proof", 30, lambda: eip4844.compute_kzg_proof(blob, z, kzg)),
        ("verify_kzg_proof", 20, lambda: eip4844.verify_kzg_proof(commitment, z, y, proof,
                                                                  kzg)),
        ("verify_blob_kzg_proof_batch 16", 10, lambda: eip4844.verify_blob_kzg_proof_batch(
            blobs16, coms16, proofs16, kzg)),
        ("compute_cells", 200, lambda: peerdas.compute_cells(blob, das)),
        ("verify_cell_kzg_proof_batch 128", 20, lambda: peerdas.verify_cell_kzg_proof_batch(
            [commitment] * 128, list(range(128)), cells, proofs, das)),
        ("recover from 64", 30, lambda: peerdas.recover_cells_and_kzg_proofs(
            half, [cells[i] for i in half], das)))
    for label, reps, fn in calls:
        fn()
        torch.cuda.synchronize()
        build.reset_launch_counts()
        ms = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        counts = build.launch_counts()
        per_call = {k: counts[k] / reps for k in KERNELS if k in counts and counts[k]}
        q1, med, q3 = statistics.quantiles(ms, n=4)
        print(f"{label}: median {med:.3f} ms over {reps} (quartiles {q1:.3f}, {q3:.3f}); "
              f"launches a call {json.dumps(per_call)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
