#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main paths on one NVIDIA card and check them.

    python3 chip_smoke.py

1. Builds every kernel of constantine_tpu_torch/csrc with nvcc for sm_90a
   and checks each against its plain PyTorch version at small shapes (K7
   with an infinity lane and a Y = 0 lane; K8-K10 and Field.batch_inv over
   Fp and Fr, K9 also at 0, 1 and p - 1; K13 on G1 points with both signs,
   a non-square x, an on-curve point outside G1 and x = 0 lanes; K11 on the generators, a pair with
   P = -P', a pair with P and Q both negated, and a batch of one; K12 on
   f = 1 and on Miller outputs; K3' ntt_bfly and ntt_stages, the latter
   with every combination of its load factor, store factor (periods 1 and
   n) and transposed store, with 0, 1, r - 1 lanes and w = 1).
2. Eighteen paths, each driven with every launch count set to 0 just before
   it and read just after; each must have launched every kernel it runs:
   a. fixed-base commit: loads the EIP-4844 trusted setup, builds the KZG
      context (the fixed-base tables, on the card, one ec_double_k launch
      a table layer: the setup's count is printed and checked) and commits
      to four blobs through blob_to_kzg_commitment: a zero blob (infinity), a
      sparse blob (held against the host big-int sum) and two dense blobs
      (held against tests/data/torch_kzg_golden.json, made by the JAX
      package); then 5 timed commits;
   b. online commit: get_kzg(precompute=False), the online MSM with the GLV
      split and the window combine, on the same four blobs and bytes; 5
      timed commits;
   c. batched commit: blob_to_kzg_commitment_batch of 16 blobs (zero,
      sparse, the two golden blobs, 12 dense blobs from seeds), each equal
      byte for byte to the fixed-base single commit of its blob; 3 timed;
   d. online MSM at N = 2^16 (bench.py's bls12381_g1_msm_65536 shape) over
      the first 65,536 fixed-base table rows, [2^(12j)] L_i for j < 16, with
      scalars k from a seed: equal in affine to the fixed-base commit of
      e_i = sum_j k_{4096j+i} 2^(12j) mod r; 5 timed;
   e. prove: compute_kzg_proof on the two golden blobs at bench.py's z =
      2^200 + 12345 and at a domain root, and compute_blob_kzg_proof: every
      proof and y byte equal to tests/data/torch_kzg_proof_golden.json (made
      by the JAX package); 5 timed;
   f. verify_kzg_proof (bench.py's eip4844_verify_kzg_proof): those proofs
      True, y + 1 False, a proof outside G1 or with a bad flag None; 5 timed;
   g. verify_blob_kzg_proof: a valid proof True, the other blob's False; 5
      timed;
   h. verify_blob_kzg_proof_batch at n = 64 (bench.py's
      eip4844_verify_blob_batch64): 64 seeded dense blobs, their batched
      commitments and their blob proofs True; two proofs swapped False; the
      F1 batch (a nonzero blob, C = infinity, P = [y/z]G1) False; a batch
      with the zero blob True; 3 timed.
   i. compute_cells (EIP-7594): the zero blob's 128 zero cells, the two
      golden blobs' cells against the SHA-256 in
      tests/data/torch_peerdas_golden.json (the JAX package's cells), and
      two cells recomputed on the host by the EIP-4844 barycentric formula
      over the blob's evaluation form, one in the 4096 domain (cell 5) and
      one off it (cell 100); 5 timed;
   j. compute_cells_and_kzg_proofs: the PeerDAS setup (monomial SRS, FK20
      bank on the card) timed; the golden blobs' 128 proofs byte-equal to
      the golden file, the zero blob's all infinity; 3 timed, each FK20 call
      launching ec_scalar_mul 16 times, ec_add 34 and ec_double_k never;
   k. verify_cell_kzg_proof_batch at 128 cells: all of golden blob 1 True;
      64 of each golden blob (two commitments) True; a flipped cell byte
      False; two proofs swapped False; the zero blob's cells with infinity
      commitment and proofs True; index 128 or a 2047-byte cell None; 5 timed;
   l. recover_cells_and_kzg_proofs from every other cell and from all 128:
      cells and proofs equal to path j's; from 63 cells None; 3 timed, with
      path j's launches per call.
   m. the NTT at n = 2^16 (bench.py's bls12381_fr_ntt_65536 shape): the
      four-step forward and inverse (two ntt_stages launches each) held
      exactly against the radix-2 route through a batch of one (a pass of
      12 stages, 4 ntt_bfly launches) and against each other; 5 timed each.
   n. sign 64 (Ethereum BLS, models/bls_signatures.py): derive_pubkeys and
      sign of the golden pairs byte-equal to tests/data/torch_bls_golden.json
      (made by the JAX package), 64 seeded keys and 32-byte messages, 8 of
      them equal to the host oracle (tests/bls_oracle.py), sk = 0 or r
      None; the GLS-4 route (the secret keys' digit decomposition, psi, the
      ladder and its adds) rerun under torch.cuda.set_sync_debug_mode("error")
      (no host read) and equal to sign; 1 timed;
   o. verify 64: those triples True; an altered message, two swapped
      signatures, a bad flag, x >= p, a signature outside G2 and a pubkey at
      infinity False in their lanes only; 1 timed;
   p. the sync committee: aggregate_signatures of 512 signatures of one
      message (equal to the host's) and fast_aggregate_verify over the 512
      pubkeys True; another message and a pubkey at infinity False; 1 timed;
   q. a block of 128 attestations over distinct messages, signed by the
      first 128 committee keys (p's pubkeys): aggregate_verify True;
      batch_verify with a fixed blinding True, a replaced signature False,
      with os.urandom blinding True; 1 timed.
   Each of n-q prints a path line: latency, device busy and idle share of
   one profiled call, and K1 / K9 / K11 / K12 / K13 / ec_scalar_mul / ec_add
   launches a call; then the seconds that timing one call instead of three,
   q's one aggregate_verify and its reuse of the committee's pubkeys save.
   r. EIP-2537 (models/evm_precompiles.py): every entry of
      tests/data/torch_evm_golden.json (made by the JAX package; its
      rejections None) byte for byte; then g1add and g2add, g1msm and
      g2msm at k = 128 (20,480 and 36,864 bytes: seeded points in G1 and G2
      and 255-bit scalars, equal to the host oracle's sum over the 128
      pairs) and at k = 1, the pairing check at k = 2 (a BLS signature
      check, true and false), map_fp_to_g1 and map_fp2_to_g2 of one element
      each, SHA-256 and RIPEMD-160: each profiled once (device busy, idle
      share, launches a call, within EIP2537_K1 for K1), timed (a golden
      entry's run is a timed call; one call where a call takes 0.5 s or
      more, else the median of 3), all outputs checked.
   A four-step transform and a coset transform of 8,192 (forward and
   inverse) must each be two ntt_stages launches, no other kernel, and
   two allocations (the passes' outputs: no transpose copy, no K1 temp);
   on paths i-l ntt_bfly must launch never.
   Every kernel must have launched over the paths. Prints K1's launches per
   call on each path, which must stay within K1_LAUNCHES.
3. Holds every kernel against its plain version on the card at the paths'
   shapes (K4-K6 on both the fixed-base and the online commit's streams,
   K4 with a one-run lane, a padding lane and a run of [P, -P, Q, Q, ...];
   K5 also at every merge stream the paths feed it, recorded from the entry
   points: the commit's two rounds, the online commit, the batch of 16
   dense blobs, the 2^16 MSM and 16 zero blobs, each with its (K2, M2),
   longest run, adds that need products and time;
   K7 at the online commit's (W, c) = (15, 9) and the 2^16 MSM's (11, 12)
   with an infinity lane and a Y = 0 lane,
   K1's product chains (mont_prod: m = 1-4 factors, k = 0 and 12 squarings,
   factors of period n, 4,096 (also expanded) and 1, 0, 1 and p - 1 lanes)
   over Fr and Fp, and K1's call and device time at n = 1, 16, 4,096,
   90,112 and z^N; K8 and K10 at the setup's Fp (32, 12, 3,072) and the
   paths' Fr (32, 8, 512) and (32, 8, 8,192), with device times; K3 double
   at a table layer's 4,096 points with k = 1 and 12 and at every (n, k)
   the MSM tails reach (recorded from the entry points), with infinity and
   Y = 0 lanes, its device time and chain floor;
   K9 over Fp at 512, 16 and 1 lanes and over Fr at what compute_kzg_proof
   hands it (eval_at's 512 chained lanes, the quotient's one) and at 16,
   K13 at 2, 128 and 130 lanes, K11 at 2 and 256 pairs, K12 at 1 and 256
   lanes, K3' ntt_bfly at every stage of the 4096 iNTT and 8192 NTT
   (four-step), the (64, 128) FK20 NTT and the (128, 64) cell iNTT, and at
   the 2^16 radix-2 route's last 4 stages, the column pass's store factor
   against K1's plain product with the twiddle matrix after the per-stage
   route, and ntt_stages at every pass the PeerDAS paths run (recorded from
   the entry points with its factors), each of those shapes also at every
   combination of the factors and the store, with the stage launches a
   call of paths i-l; K6 at every (T, lanes) the MSM paths reach
   (recorded from the entry points), with its chain floor; ec_scalar_mul at 64
   lanes x 255 bits with k = 0, 1, r - 1, r, r + 2 and a point at infinity,
   at 1/n's 128 lanes, a bank stage's 4,096 and the Hadamard product's
   8,192, and against the per-bit K3 composition at an EC-FFT stage's 64
   lanes and the Hadamard product's 8,192; K3 add at the tail's 512 lanes
   and FK20's 64 and 128), with hand-built degenerate lanes (P == Q,
   P == -Q, infinity, padding keys): exact equality. Times both, and
   computes each kernel's bound from the bytes it must move and the
   multiplies it must do on these inputs. Holds K4 also at the batch of 16
   (K = 1,472, M = 1,024; 16 dense blobs, and 16 zero blobs, whose lanes
   are one run each) and at the 2^16 MSM (K = 1,408), once each (the plain
   version takes ~25 s there), and times it; K3 add's, K6's and
   ntt_stages' device time (CUDA events around calls queued behind a
   sleeping kernel) beside their call time. Prints the pairing
   kernels' programs (rounds, rounds with a product, the inverse's lone
   multiplies) and their chain floor, and K13's and K7's (3 rounds a
   doubling), from fe_mul_eo's latency in a lone thread measured here, and
   K9's divsteps, batches and word operations a lane (its bound's count). Times the pairing at B = 256 (bench.py's
   bls12381_pairing_batch256). Holds every kernel path r launches against
   its plain version at the first input of each distinct shape that path
   r's entry points hand it (recorded from them: K1's products of the G2
   flat route, the G1 MSM's K3-K7 streams, K9, K11, K12), the seconds
   of each kind, and path r's seconds (its calls and these checks)
   beside those the cuts to n-q saved.
4. Prints the seconds of each group of the above and the total, the
   kernels' JSON line, then the result line.

Any failed check exits non-zero before the result line; so does a machine
without a CUDA card, or a directory without the port beside this script.
"""

import ctypes
import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "data" / "torch_kzg_golden.json"
PROOF_GOLDEN = ROOT / "tests" / "data" / "torch_kzg_proof_golden.json"
PEERDAS_GOLDEN = ROOT / "tests" / "data" / "torch_peerdas_golden.json"
BLS_GOLDEN = ROOT / "tests" / "data" / "torch_bls_golden.json"
EVM_GOLDEN = ROOT / "tests" / "data" / "torch_evm_golden.json"
INF = bytes([0xC0]) + bytes(47)

# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 bandwidth, and for the
# operations the FP32 (non-tensor) rate, counting a 32x32->64 multiply-add as
# 2 operations like an FMA. The data sheet gives no 32-bit integer rate;
# Hopper issues integer multiply-adds at half the FP32 rate, so the bound is
# optimistic.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
NL = 12
MUL_OPS = 2 * (2 * NL * NL + NL)          # one 12-limb CIOS multiply
FR_MUL_OPS = 2 * (2 * 8 * 8 + 8)          # one 8-limb (Fr) CIOS multiply
MULS = {"madd": 11, "add": 16, "double": 7}
FE_BYTES = 4 * NL

EC_SRC = "constantine_tpu_torch/csrc/ec_kernels.cu"
FIELD_SRC = "constantine_tpu_torch/csrc/field_kernels.cu"
G1_SRC = "constantine_tpu_torch/csrc/g1_kernels.cu"
MILLER_SRC = "constantine_tpu_torch/csrc/miller_loop.cu"
FINAL_EXP_SRC = "constantine_tpu_torch/csrc/final_exp.cu"
NTT_SRC = "constantine_tpu_torch/csrc/ntt_kernels.cu"
REPLACES = {
    "mont_mul": (FIELD_SRC, "constantine_tpu/ops/pallas_field.py:89"),
    "ec_add": (EC_SRC, "constantine_tpu/ops/pallas_ec.py:543"),
    "ec_double_k": (EC_SRC, "constantine_tpu/ops/pallas_ec.py:543"),
    "ec_scalar_mul": (EC_SRC, "constantine_tpu/ops/pallas_ec.py:543"),
    "flush_scan": (EC_SRC, "constantine_tpu/ops/pallas_ec.py:745"),
    "merge_scan": (EC_SRC, "constantine_tpu/ops/pallas_ec.py:828"),
    "bucket_reduce": (EC_SRC, "constantine_tpu/ops/pallas_ec.py:910"),
    "scaled_doubles": (EC_SRC, "constantine_tpu/ops/pallas_ec.py:977"),
    "chain_fwd": (FIELD_SRC, "constantine_tpu/ops/pallas_ec.py:1078"),
    "fermat_inv": (FIELD_SRC, "constantine_tpu/ops/pallas_ec.py:1126"),
    "chain_bwd_inv": (FIELD_SRC, "constantine_tpu/ops/pallas_ec.py:1196"),
    "g1_decompress": (G1_SRC, "constantine_tpu/ops/pallas_g1.py:122"),
    "miller_loop": (MILLER_SRC, "constantine_tpu/ops/pallas_pairing.py:633"),
    "final_exp": (FINAL_EXP_SRC, "constantine_tpu/ops/pallas_pairing.py:712"),
    "ntt_bfly": (NTT_SRC, "constantine_tpu/ops/ntt.py:168"),
    "ntt_stages": (NTT_SRC, "constantine_tpu/ops/ntt.py:168; constantine_tpu/ops/ntt.py:198"),
}
PIPELINE = ("mont_mul", "ec_add", "ec_double_k", "flush_scan", "merge_scan", "bucket_reduce")
# what each path must launch: the fixed-base setup inverts 90,112 points
# through the chains, every export inverts through fermat_inv, and the
# online MSMs combine windows with scaled_doubles (the bare MSM returns a
# Jacobian point: no inversion); proving inverts 4096 denominators through
# the chains and checks the commitment with K13; every verify decompresses
# with K13, adds table points with K3 and runs the pairing (K11, K12); the
# blob verifies evaluate through the chains; the batch folds with two online
# MSMs; compute_cells runs two four-step transforms (K3', K1 for the
# Montgomery conversions); FK20 adds the batched radix-2 NTT, the
# scalar multiplications (ec_scalar_mul, one launch each) and the EC-FFT
# butterflies and tree (K3 add), and compresses through K9; the
# cell verify decompresses with K13, runs the cell iNTT, two online MSMs and
# the pairing; recovery adds the coset transforms and Fr inversions
# (K8-K10); the 2^16 NTT runs the four-step and, through a batch of one,
# the radix-2 route, whose last 4 stages are ntt_bfly's (and its 1/n a K1
# product). K3' runs a transform's passes as ntt_stages launches, its
# pointwise products (the twiddle matrix, 1/n, the coset shifts) as their
# factors: 2 a four-step or coset transform, 1 a batched radix-2, so the
# stage launches a call are at most
STAGE_LAUNCHES = {"cells": 4, "cells and proofs": 5, "verify cells": 1, "recover": 13}
# the paths that never launch ntt_bfly: every transform of theirs fits the passes
NO_BFLY = ("cells", "cells and proofs", "verify cells", "recover")
# K1 launches a call at most (one launch a product chain; 222 in all before)
K1_LAUNCHES = {"commit": 3, "online commit": 4, "batch 16": 3, "msm 2^16": 1, "prove": 12,
               "verify": 39, "verify blob": 45, "verify batch 64": 13, "cells": 2,
               "cells and proofs": 6, "verify cells": 8, "recover": 8, "ntt 2^16": 1}
# path r's K1 launches a call at most, by call (a G2 operation's products
# are 5-9 launches; the G1 and G2 subgroup checks' ladders most of the rest)
EIP2537_K1 = {"g1add": 11, "g2add": 18, "g1msm k=128": 601, "g1msm k=1": 601,
              "g2msm k=128": 793, "g2msm k=1": 856, "pairingcheck k=2 true": 882,
              "pairingcheck k=2 false": 882, "map_fp_to_g1": 518, "map_fp2_to_g2": 1106,
              "sha256": 0, "ripemd160": 0}
# path r times one call where a call takes at least this many ms, else three
EIP2537_CHEAP_MS = 500
PAIRING = ("mont_mul", "ec_add", "fermat_inv", "g1_decompress", "miller_loop", "final_exp")
# an FK20 call (paths j and l): 16 scalar multiplications (the Hadamard
# product, 7 + 1 of the inverse EC-FFT, 7 of the EC-FFT), 28 butterfly adds
# and 6 tree levels
FK20_LAUNCHES = {"ec_scalar_mul": 16, "ec_add": 34, "ec_double_k": 0}
# products a bit of ec_scalar_mul's ladder (double 7, add 14)
LADDER_MULS = 21
CHAINS = ("chain_fwd", "fermat_inv", "chain_bwd_inv")


def _union(*groups):
    return tuple(dict.fromkeys(k for g in groups for k in g))


PATH_KERNELS = {
    "commit": _union(PIPELINE, CHAINS),
    "online commit": PIPELINE + ("scaled_doubles", "fermat_inv"),
    "batch 16": PIPELINE + ("fermat_inv",),
    "msm 2^16": PIPELINE + ("scaled_doubles",),
    "prove": _union(PIPELINE, CHAINS, ("g1_decompress",)),
    "verify": PAIRING,
    "verify blob": _union(PAIRING, CHAINS),
    "verify batch 64": _union(PIPELINE, ("scaled_doubles",), CHAINS, PAIRING),
    "cells": ("mont_mul", "ntt_stages"),
    "cells and proofs": ("mont_mul", "ntt_stages", "ec_add", "ec_scalar_mul", "fermat_inv"),
    "verify cells": _union(PIPELINE, ("scaled_doubles", "ntt_stages"), PAIRING),
    "recover": _union(("mont_mul", "ntt_stages", "ec_add", "ec_scalar_mul"), CHAINS),
    "ntt 2^16": ("mont_mul", "ntt_stages", "ntt_bfly"),
    # BLS signatures: the G2 and Fp2 glue is K1 products; pubkeys are
    # ec_scalar_mul ladders, decompressed by K13; every affine conversion
    # inverts through K9; pubkey sums are K3 adds; pairings K11 and K12
    "sign 64": ("mont_mul", "ec_scalar_mul", "fermat_inv"),
    "verify 64": ("mont_mul", "fermat_inv", "g1_decompress", "miller_loop", "final_exp"),
    "sync committee 512": PAIRING,
    "block 128": ("mont_mul", "ec_scalar_mul", "fermat_inv", "g1_decompress", "miller_loop",
                  "final_exp"),
    # EIP-2537: the G2 flat route, the maps, the subgroup checks and the G1
    # subgroup ladder are K1 products; the G1 adds K3, the G1 MSM the
    # pipeline and the window combine, G1 cofactor clearing ec_scalar_mul;
    # every affine conversion K9; the pairing check K11, K12
    "eip2537": _union(PIPELINE, ("scaled_doubles", "ec_scalar_mul", "fermat_inv", "miller_loop",
                                 "final_exp")),
}
# the launches a BLS path line reports per call
BLS_COUNTED = ("mont_mul", "fermat_inv", "miller_loop", "final_exp", "g1_decompress",
               "ec_scalar_mul", "ec_add")


def _windows(e: int):
    """e's 4-bit digits, least significant first, as ops/cuda_g1.py packs
    them for csrc/g1.cuh."""
    import numpy as np
    from constantine_tpu_torch.ops.cuda_g1 import window_words
    w = window_words(e)
    return w[:-1].view(np.uint8)[:int(w[-1])].tolist()


def k13_muls(p: int, u: int) -> int:
    """Multiplies of one K13 lane (csrc/g1.cuh g1_decompress_team): x^3 + 4,
    the square root's 14-product window table, 4 squarings a window and a
    product for each nonzero digit below the top, y^2 and y's canonical
    form, the ladder over u^2 (a doubling is 7, a mixed addition 11) and
    the comparison's 5."""
    d, u2 = _windows((p + 1) // 4), u * u
    return (2 + 14 + 4 * (len(d) - 1) + sum(1 for w in d[:-1] if w) + 2
            + 7 * (u2.bit_length() - 1) + 11 * (bin(u2).count("1") - 1) + 5)


def k13_chain(p: int, u: int, T: int = 4) -> int:
    """Dependent multiplies of a K13 lane for a team of T: each level of
    independent products takes ceil(size / T) (the table's levels of 1, 2,
    4 and 7; y^2 with y's canonical form; a doubling's 3, 3, 1; a mixed
    addition's 2, 2, 3, 2, 2; the comparison's 3, 2), every squaring and
    window product one."""
    d, u2 = _windows((p + 1) // 4), u * u

    def rounds(*levels):
        return sum(-(-k // T) for k in levels)

    return (2 + rounds(1, 2, 4, 7) + 4 * (len(d) - 1) + sum(1 for w in d[:-1] if w)
            + rounds(2) + (u2.bit_length() - 1) * rounds(3, 3, 1)
            + (bin(u2).count("1") - 1) * rounds(2, 2, 3, 2, 2) + rounds(3, 2))


def record_calls(obj, name, fn, keywords=False):
    """The arguments of every call of obj.<name> (a method, or a module's
    function) that fn makes, tensors cloned: the positional ones, or
    (positional, keywords) if `keywords`."""
    seen = []
    own = name in vars(obj)
    orig = getattr(obj, name)

    def clone(a):
        return a.clone() if hasattr(a, "clone") else a

    def rec(*args, **kw):
        pos = tuple(clone(a) for a in args)
        seen.append((pos, {k: clone(v) for k, v in kw.items()}) if keywords else pos)
        return orig(*args, **kw)

    setattr(obj, name, rec)
    try:
        fn()
    finally:
        if own:
            setattr(obj, name, orig)
        else:
            delattr(obj, name)
    return seen


def record_merges(pec, fn):
    """The inputs of every merge_scan call that fn makes, cloned."""
    return record_calls(pec, "merge_scan", fn)


# Word operations in csrc/inv.cuh's safegcd: one divstep (shifts, masks,
# xors, adds: 28), and per limb of the batch's matrix applied to f and g (4
# multiply-adds, 2 operations each, 2 masks and 2 shifts) and to d and e (6
# multiply-adds, 2 masks, 2 shifts).
DIVSTEP_OPS = 28
MATRIX_LIMB_OPS = (2 * 4 + 4) + (2 * 6 + 4)


def inv_batches(m: int):
    """K9's divsteps for the modulus m (Bernstein-Yang's bound, csrc/inv.cuh),
    its batches of INV_BITS (read from inv.cuh) and the word operations of a
    lane, the bound's count: each batch's divsteps and its matrix on f, g, d
    and e of L = ceil((32 N + 2) / INV_BITS) limbs, then one N-limb fe_mul
    (the final normalisation's few passes over L limbs left out)."""
    import re
    bits = int(re.search(r"constexpr int INV_BITS = (\d+);",
                         (ROOT / "constantine_tpu_torch/csrc/inv.cuh").read_text()).group(1))
    d = m.bit_length()
    n = 12 if d > 256 else 8
    steps = (49 * d + 57) // 17 if d >= 46 else (49 * d + 80) // 17
    batches = -(-steps // bits)
    limbs = -(-(32 * n + 2) // bits)
    ops = batches * (bits * DIVSTEP_OPS + limbs * MATRIX_LIMB_OPS) + 2 * (2 * n * n + n)
    return steps, bits, batches, ops


def merge_work(keys, qz, ez):
    """What a merge stream asks of K5: its longest run of a key > 0, the
    adds that need products (the key stays, > 0, and neither the entry nor
    the accumulator before it is infinity: ez is the scan's output), and the
    most of those in one lane and in one run."""
    import numpy as np
    k = keys.cpu().numpy()
    qinf = (qz == 0).all(1).cpu().numpy()
    einf = (ez == 0).all(1).cpu().numpy()
    same = np.zeros_like(k, dtype=bool)
    same[1:] = k[1:] == k[:-1]
    same[0] = k[0] == -1
    add = same & (k > 0) & ~qinf
    add[1:] &= ~einf[:-1]
    add[0] = False
    start = np.ones(k.T.shape, dtype=bool)
    start[:, 1:] = k.T[:, 1:] != k.T[:, :-1]
    ids = np.cumsum(start.reshape(-1)) - 1
    lengths = np.bincount(ids)
    run_key = k.T.reshape(-1)[start.reshape(-1)]
    pos = lengths[run_key > 0]
    return (int(pos.max()) if pos.size else 0, int(add.sum()), int(add.sum(0).max()),
            int(np.bincount(ids, weights=add.T.reshape(-1)).max()))


PROGRAM_STATS = ("T", "rounds", "product rounds", "inverse multiplies", "products", "sums",
                 "slots")


def program_stats(lib, symbol, consts):
    """What the program of a pairing kernel (csrc/pairing.cuh) is made of, as
    the kernel's library builds it: its team size, rounds, rounds with a
    product, the inverse's lone multiplies, product and sum tasks, slots."""
    out = (ctypes.c_int * len(PROGRAM_STATS))()
    fn = getattr(lib, symbol)
    fn.argtypes, fn.restype = [ctypes.c_void_p, ctypes.c_void_p], ctypes.c_int
    fn(ctypes.c_void_p(consts.ctypes.data), out)
    return dict(zip(PROGRAM_STATS, out))


class CheckFailed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise CheckFailed(msg)


def dense_blob(seed: int, r: int) -> bytes:
    """Same recipe as tests/test_torch_eip4844.py:dense_blob."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return b"".join((int.from_bytes(rng.bytes(32), "big") % r).to_bytes(32, "big")
                    for _ in range(4096))


def host_cell(blob: bytes, cell: int, ctx, brp12, brp13) -> bytes:
    """Cell `cell` of the extended blob on the host: the blob's polynomial at
    the cell's 64 points w_8192^brp13[64 cell + j] by the EIP-4844
    barycentric formula over its evaluation form (brp order), with the
    in-domain branch y = p_m for a point equal to root m."""
    r, N = ctx.r, 4096
    w12, w13 = ctx.root_of_unity(12), ctx.root_of_unity(13)
    roots = [pow(w12, int(b), r) for b in brp12]
    where = {w: m for m, w in enumerate(roots)}
    evals = [int.from_bytes(blob[32 * i:32 * (i + 1)], "big") for i in range(N)]
    inv_n = pow(N, -1, r)
    out = []
    for j in range(64):
        z = pow(w13, int(brp13[64 * cell + j]), r)
        if z in where:
            out.append(evals[where[z]])
            continue
        acc = sum(e * w * pow(z - w, -1, r) for e, w in zip(evals, roots)) % r
        out.append((pow(z, N, r) - 1) * inv_n % r * acc % r)
    return b"".join(v.to_bytes(32, "big") for v in out)


def cuda_ms(torch, fn, reps):
    """Mean milliseconds per call over `reps` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(torch, fn, reps):
    """Host-clock milliseconds of `reps` calls, each ending synchronised."""
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def device_by_kernel(torch, names, fn, warm=True):
    """Device time of a call of fn by kernel (torch.profiler, tracing the
    device alone): a span is kernel k's when its name holds k + "_kernel",
    else "torch ops". Returns ({name: (launches, us)}, wall us of the
    call). warm: one call before the profiled one."""
    from torch.profiler import ProfilerActivity, profile
    if warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name, kind = {}, {}
    cuda = torch.autograd.DeviceType.CUDA
    # the raw trace events: prof.events() builds a Python object a span and
    # takes minutes over the BLS paths' ~10^6 spans; a span's kernel is
    # looked up once a distinct span name
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            ename = e.name()
            name = kind.get(ename)
            if name is None:
                name = kind[ename] = next((k for k in names if k + "_kernel" in ename),
                                          "torch ops")
            n, t = by_name.get(name, (0, 0.0))
            by_name[name] = (n + 1, t + e.duration_ns() / 1e3)
    return by_name, wall_us


def profile_call(torch, names, label, fn, warm=True):
    """Device time by kernel over one call, and the share of the call's wall
    time the device spent idle: (busy ms, idle share), or None."""
    by_name, wall_us = device_by_kernel(torch, names, fn, warm)
    busy_us = sum(t for _, t in by_name.values())
    if busy_us == 0:
        print(f"profile of one {label}: the profiler recorded no device time "
              "(idle share not measured)", flush=True)
        return None
    parts = ", ".join(f"{k} {t / 1e3:.3f} ms x{n}" for k, (n, t) in
                      sorted(by_name.items(), key=lambda kv: -kv[1][1]))
    print(f"profile of one {label}: wall {wall_us / 1e3:.3f} ms, device busy "
          f"{busy_us / 1e3:.3f} ms, idle share {1 - busy_us / wall_us:.3f}; {parts}", flush=True)
    return busy_us / 1e3, 1 - busy_us / wall_us


def device_ms(torch, fn, reps):
    """Device milliseconds of a call of fn when `reps` calls run back to back
    on the card: the calls are queued behind a sleeping kernel that outlasts
    the host's enqueue of them, so the events around them time the device,
    not the host (for a call of one launch: its kernel and the gap to the
    next). None when the host could not enqueue them in time. The profiler
    is not used here: over many calls it kept only some of the kernels
    (PERF.md)."""
    fn()
    torch.cuda.synchronize()
    cycles = 200_000 * reps
    for _ in range(3):
        e0, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        t0 = time.perf_counter()
        e0.record()
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if host_ms < e0.elapsed_time(start):
            return start.elapsed_time(end) / reps
        cycles *= 4
    return None


def enqueue_ms(torch, fn, reps):
    """Host milliseconds a call of fn takes to return, over `reps` calls
    issued back to back (the device catches up after)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return host


def longest_run(keys):
    """Steps of the longest run of equal keys down a lane of (K, M) keys."""
    import numpy as np
    kn = keys.cpu().numpy().T
    start = np.ones_like(kn, dtype=bool)
    start[:, 1:] = kn[:, 1:] != kn[:, :-1]
    return int(np.bincount(np.cumsum(start.reshape(-1))).max())


def bound(nbytes, nmuls, mul_ops=MUL_OPS):
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = nmuls * mul_ops / PEAK_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def max_abs_err(lb, got, ref):
    """Largest |difference| of limb values (u32) over the outputs."""
    import numpy as np
    err = 0
    for a, b in zip(got, ref):
        d = np.abs(lb.to_numpy(a).astype(np.int64) - lb.to_numpy(b).astype(np.int64))
        err = max(err, int(d.max()) if d.size else 0)
    return err


def bls_paths(torch, np, ctx, dev, start_path, end_path, per_call):
    """Paths n-q: Ethereum BLS signatures through the port's entry points,
    each checked, timed (one call, whose result is checked too) and profiled
    once: sign and verify of 64, the 512-key sync committee, a block of 128
    attestations. Returns the seconds that timing one call instead of three
    saves: twice the timed calls' latencies."""
    n_sign, n_committee, n_block = 64, 512, 128
    from constantine_tpu_torch import build
    from constantine_tpu_torch.models import bls_signatures
    from constantine_tpu_torch.ops.glv import get_gls4, gls4_combine, gls4_split
    from constantine_tpu_torch.utils import refmath as rm
    sys.path.insert(0, str(ROOT / "tests"))
    from bls_oracle import host_pubkeys, host_sign

    t_start = time.perf_counter()
    r = ctx.r
    inf1 = bytes([0xC0]) + bytes(47)
    names = tuple(build.KERNELS)
    bls = bls_signatures.get_bls("cuda")
    golden = json.loads(BLS_GOLDEN.read_text())["pairs"]
    gsks = [int(e["sk"], 16) for e in golden]
    gmsgs = [bytes.fromhex(e["msg"]) for e in golden]
    gpks = b"".join(bytes.fromhex(e["pubkey"]) for e in golden)
    gsigs = b"".join(bytes.fromhex(e["signature"]) for e in golden)
    rng = np.random.default_rng(2026)

    def keys(n):
        return [int.from_bytes(rng.bytes(32), "big") % (r - 1) + 1 for _ in range(n)]

    saved_ms = []

    def timed(fn):
        """One call, ending synchronised: ([result], [host ms])."""
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        lat = [(time.perf_counter() - t0) * 1e3]
        saved_ms.append(2 * lat[0])
        return [out], lat

    def finish(name, before, lat, what, fn):
        end_path(name, before, len(lat))
        prof = profile_call(torch, names, name, fn, warm=False)
        med = statistics.median(lat)
        busy = "not measured" if prof is None else f"{prof[0]:.3f} ms"
        idle = "not measured" if prof is None else f"{prof[1]:.3f}"
        calls = ", ".join(f"{k} {per_call[name][k]:g}" for k in BLS_COUNTED)
        print(f"path {name} ({what}): latency median {med:.3f} ms over {len(lat)} (min "
              f"{min(lat):.3f}, max {max(lat):.3f}); device busy {busy}, idle share {idle}; "
              f"launches a call: {calls}; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; "
              f"{time.perf_counter() - t_start:.1f} s into the BLS paths", flush=True)

    # n. derive_pubkeys and sign over 64 seeded keys and 32-byte messages
    sks64, msgs64 = keys(n_sign), [rng.bytes(32) for _ in range(n_sign)]
    torch.cuda.reset_peak_memory_stats()
    start_path()
    check(bls.derive_pubkeys(gsks) == gpks, "derive_pubkeys of the golden keys")
    check(bls.sign(gsks, gmsgs) == gsigs, "sign of the golden pairs")
    check(bls.sign([0], [b"m"]) is None and bls.sign([5, r], [b"m", b"n"]) is None,
          "sign with sk = 0 or r is not None")
    pks64 = bls.derive_pubkeys(sks64)
    check(pks64[:8 * 48] == host_pubkeys(sks64[:8]), "derive_pubkeys: 8 pubkeys != host")
    before = build.launch_counts()
    out, lat = timed(lambda: bls.sign(sks64, msgs64))
    sigs64 = out[0]
    check(sigs64[:8 * 96] == host_sign(sks64[:8], msgs64[:8]), "sign: 8 signatures != host")
    finish("sign 64", before, lat, "sign of 64 keys and messages",
           lambda: bls.sign(sks64, msgs64))
    # the GLS-4 route, its scalars and hashed points already on the card,
    # may not read the device: the digit decomposition of the secret keys,
    # psi, the ladder and the adds (a synchronising call raises in this mode)
    g2 = ctx.g2
    (hx, hy), _ = bls._hash(msgs64)
    sk_limbs = ctx.scalars_to_limbs(sks64, dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        kk, pts = gls4_split(ctx, sk_limbs, (hx, hy))
        acc = g2.scalar_mul(kk, g2.from_affine(pts), scalar_bits=get_gls4().mini_bits)
        S = gls4_combine(ctx, acc, n_sign)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    check(bls.codec.g2_compress(g2.to_affine(S)[0]) == sigs64,
          "the GLS-4 ladder under the sync debug mode differs from sign")
    print("sign 64: golden pubkeys and signatures match, 8 of the 64 equal the host oracle, "
          "sk = 0 and r give None; the GLS-4 decomposition, ladder and adds ran under "
          f"torch.cuda.set_sync_debug_mode('error') without a host read "
          f"({time.perf_counter() - t_start:.1f} s into the BLS paths)", flush=True)

    # o. verify the 64 triples, then a batch with one fault a lane
    # an SSWU output before cofactor clearing: on the twist, outside G2
    outside_pt = bls.h2c.g2_map.map_to_curve(ctx.g2.F.encode([3, 4], dev)[None])
    outside = bls.codec.g2_compress(outside_pt)
    q_out = tuple(tuple(ctx.fp.decode(c[0].cpu())) for c in outside_pt)
    check(rm.ec2_is_on_curve(q_out, ctx.g2_b(), -1, ctx.p)
          and rm.ec2_mul(r, q_out, (0, 0), -1, ctx.p) is not None,
          "the outside-G2 signature is not on the twist outside G2")
    sig = [sigs64[96 * i:96 * i + 96] for i in range(n_sign)]
    pk = [pks64[48 * i:48 * i + 48] for i in range(n_sign)]
    bad_msgs, bad_sig, bad_pk = list(msgs64), list(sig), list(pk)
    bad_msgs[5] = b"altered"
    bad_sig[10], bad_sig[11] = sig[11], sig[10]
    bad_sig[20] = bytes([sig[20][0] & 0x7F]) + sig[20][1:]
    bad_sig[21] = sig[21][:48] + (ctx.p + 1).to_bytes(48, "big")
    bad_sig[22] = outside
    bad_pk[30] = inf1
    want = [i not in (5, 10, 11, 20, 21, 22, 30) for i in range(n_sign)]
    torch.cuda.reset_peak_memory_stats()
    start_path()
    got = bls.verify(b"".join(bad_pk), bad_msgs, b"".join(bad_sig)).tolist()
    check(got == want, f"verify 64 faults: {[i for i, w in enumerate(want) if got[i] != w]} wrong")
    before = build.launch_counts()
    out, lat = timed(lambda: bls.verify(pks64, msgs64, sigs64))
    check(all(o.tolist() == [True] * n_sign for o in out), "verify 64 valid")
    print("verify 64: all True; an altered message, two swapped signatures, a bad flag, "
          f"x >= p, a signature outside G2 and a pubkey at infinity False in their lanes only "
          f"({time.perf_counter() - t_start:.1f} s into the BLS paths)", flush=True)
    finish("verify 64", before, lat, "verify of 64 triples",
           lambda: bls.verify(pks64, msgs64, sigs64))

    # p. the sync committee: 512 keys sign one message; q's block of 128
    # distinct messages is signed by the first 128 of them, in the same call
    sks512, msg = keys(n_committee), rng.bytes(32)
    msgs128 = [rng.bytes(32) for _ in range(n_block)]
    t0 = time.perf_counter()
    pks512 = bls.derive_pubkeys(sks512)
    derive_ms = (time.perf_counter() - t0) * 1e3
    both = bls.sign(sks512 + sks512[:n_block], [msg] * n_committee + msgs128)
    sigs512, sigs128 = both[:96 * n_committee], both[96 * n_committee:]
    torch.cuda.reset_peak_memory_stats()
    start_path()
    t0 = time.perf_counter()
    agg = bls.aggregate_signatures(sigs512)
    agg_ms = (time.perf_counter() - t0) * 1e3
    check(agg == host_sign([sum(sks512) % r], [msg]), "aggregate of 512 != host")
    check(bls.fast_aggregate_verify(pks512, b"another", agg) is False,
          "fast_aggregate_verify of another message")
    check(bls.fast_aggregate_verify(pks512[:48] + inf1 + pks512[96:], msg, agg) is False,
          "fast_aggregate_verify with a pubkey at infinity")
    before = build.launch_counts()
    out, lat = timed(lambda: bls.fast_aggregate_verify(pks512, msg, agg))
    check(out == [True], "fast_aggregate_verify 512")
    print(f"sync committee 512: aggregate_signatures ({agg_ms:.3f} ms) equals the host's; "
          "fast_aggregate_verify True; another message and a pubkey at infinity False "
          f"({time.perf_counter() - t_start:.1f} s into the BLS paths)", flush=True)
    finish("sync committee 512", before, lat, "fast_aggregate_verify of 512 pubkeys",
           lambda: bls.fast_aggregate_verify(pks512, msg, agg))

    # q. a block: 128 attestations over distinct messages, by the first 128
    # committee keys (their pubkeys derived once, on p); the replaced
    # signature is attestation 2's in slot 1
    pks128 = pks512[:48 * n_block]
    replaced = sigs128[:96] + sigs128[192:288] + sigs128[192:]
    seed = b"\x05" * 32
    torch.cuda.reset_peak_memory_stats()
    start_path()
    agg = bls.aggregate_signatures(sigs128)
    t0 = time.perf_counter()
    check(bls.aggregate_verify(pks128, msgs128, agg) is True, "aggregate_verify 128")
    av_ms = (time.perf_counter() - t0) * 1e3
    check(bls.batch_verify(pks128, msgs128, replaced, secure_blinding=seed) is False,
          "batch_verify with a replaced signature")
    check(bls.batch_verify(pks128, msgs128, sigs128) is True,
          "batch_verify with os.urandom blinding")
    before = build.launch_counts()
    out, lat = timed(lambda: bls.batch_verify(pks128, msgs128, sigs128, seed))
    check(out == [True], "batch_verify 128")
    print(f"block 128: aggregate_verify True ({av_ms:.3f} ms); "
          "batch_verify True, a replaced signature False, os.urandom blinding True "
          f"({time.perf_counter() - t_start:.1f} s into the BLS paths)", flush=True)
    finish("block 128", before, lat, "batch_verify of 128 triples",
           lambda: bls.batch_verify(pks128, msgs128, sigs128, seed))
    one_call = sum(saved_ms) / 1e3
    freed = one_call + (av_ms + derive_ms) / 1e3
    print(f"paths n-q time one call each instead of three: that saves {one_call:.1f} s "
          f"(twice the timed calls' latencies, {', '.join(f'{m / 2e3:.1f}' for m in saved_ms)} s); "
          f"q no longer runs a second aggregate_verify (as long as the first, {av_ms / 1e3:.1f} s) "
          f"nor derives its own 128 pubkeys (it takes the committee's; the committee's derive "
          f"took {derive_ms / 1e3:.1f} s): {freed:.1f} s in all", flush=True)
    return freed



def eip2537_inputs(np, ctx):
    """Path r's calldata at the EIP's widths: k = 128 (G1 point, scalar) and
    (G2 point, scalar) pairs (20,480 and 36,864 bytes), the points [a + i d]G
    and [a' + i d']H built on the host by additions, so their discrete logs
    are known and the host oracle's sum over all 128 pairs is one refmath
    multiplication of the generator by sum_i k_i (a + i d) mod r; 255-bit
    scalars from a seed."""
    from constantine_tpu_torch.utils import refmath as rm
    sys.path.insert(0, str(ROOT / "tests"))
    from bls_oracle import NR, g1_bytes, g2_bytes
    p, r = ctx.p, ctx.r
    rng = np.random.default_rng(2537128)

    def k255():
        return int.from_bytes(rng.bytes(32), "big") >> 1

    def progression(add, mul, gen):
        a, d = (int.from_bytes(rng.bytes(32), "big") % r for _ in range(2))
        step, pts = mul(d, gen), [mul(a, gen)]
        for _ in range(127):
            pts.append(add(pts[-1], step))
        return pts, [(a + i * d) % r for i in range(128)]

    g1pts, g1logs = progression(lambda P, Q: rm.ec_add(P, Q, 0, p),
                                lambda k, P: rm.ec_mul(k, P, 0, p), ctx.g)
    g2pts, g2logs = progression(lambda P, Q: rm.ec2_add(P, Q, (0, 0), NR, p),
                                lambda k, P: rm.ec2_mul(k, P, (0, 0), NR, p), ctx.g2_aff)
    ks1, ks2 = [k255() for _ in range(128)], [k255() for _ in range(128)]
    g1data = b"".join(g1_bytes(P) + k.to_bytes(32, "big") for P, k in zip(g1pts, ks1))
    g2data = b"".join(g2_bytes(Q) + k.to_bytes(32, "big") for Q, k in zip(g2pts, ks2))
    check(len(g1data) == 20480 and len(g2data) == 36864, "path r: calldata widths")
    g1want = g1_bytes(rm.ec_mul(sum(k * l for k, l in zip(ks1, g1logs)) % r, ctx.g, 0, p))
    g2want = g2_bytes(rm.ec2_mul(sum(k * l for k, l in zip(ks2, g2logs)) % r, ctx.g2_aff,
                                 (0, 0), NR, p))
    return {"g1msm k=128": (g1data, g1want), "g2msm k=128": (g2data, g2want)}


def eip2537_calls(np, ctx):
    """Path r's calls: [(label, op, calldata, expected bytes)]. The MSMs at
    k = 128 take eip2537_inputs; the rest (the adds, the MSMs at k = 1, the
    pairing check true and false, the maps and the hashes) their golden
    entries."""
    entries = json.loads(EVM_GOLDEN.read_text())["entries"]

    def entry(op, note):
        e = next(e for e in entries if e["op"] == op and e["note"] == note)
        return bytes.fromhex(e["input"]), bytes.fromhex(e["output"])

    msms = eip2537_inputs(np, ctx)
    return [("g1add", "g1add", *entry("g1add", "P + Q")),
            ("g2add", "g2add", *entry("g2add", "Q + R")),
            ("g1msm k=128", "g1msm", *msms["g1msm k=128"]),
            ("g1msm k=1", "g1msm", *entry("g1msm", "k = 1")),
            ("g2msm k=128", "g2msm", *msms["g2msm k=128"]),
            ("g2msm k=1", "g2msm", *entry("g2msm", "k = 1")),
            ("pairingcheck k=2 true", "pairingcheck", *entry("pairingcheck", "k = 2, true")),
            ("pairingcheck k=2 false", "pairingcheck", *entry("pairingcheck", "k = 2, false")),
            ("map_fp_to_g1", "map_fp_to_g1", *entry("map_fp_to_g1", "seeded")),
            ("map_fp2_to_g2", "map_fp2_to_g2", *entry("map_fp2_to_g2", "seeded")),
            ("sha256", "sha256", *entry("sha256", "100 seeded bytes")),
            ("ripemd160", "ripemd160", *entry("ripemd160", "100 seeded bytes"))]


def eip2537_ops():
    from constantine_tpu_torch.models import evm_precompiles as E
    ops = {name: getattr(E, f"eth_evm_bls12381_{name}") for name in (
        "g1add", "g2add", "g1msm", "g2msm", "pairingcheck", "map_fp_to_g1", "map_fp2_to_g2")}
    ops.update(sha256=E.eth_evm_sha256, ripemd160=E.eth_evm_ripemd160)
    return ops


class KernelInputs:
    """A context that records, for every kernel wrapper path r reaches, the
    arguments of its first call with each distinct set of argument shapes
    (and strides, and non-tensor arguments); ``check`` then holds each
    recorded call against the kernel's plain version."""

    def __init__(self, torch, ctx):
        from constantine_tpu_torch.ops import cuda_field, field as field_mod
        from constantine_tpu_torch.ops.pairing import get_pairing
        self.torch, self.cf = torch, cuda_field
        self.pec, self.aff = ctx.g1.pec, ctx.fp.affine
        self.eng = get_pairing(ctx.name).engine
        pec, aff, eng = self.pec, self.aff, self.eng
        self.targets = [(cuda_field, "mont_prod"), (field_mod, "mont_prod"), (pec, "add"),
                        (pec, "double_k"), (pec, "flush_scan"), (pec, "merge_scan"),
                        (pec, "bucket_reduce"), (pec, "scaled_doubles"), (pec, "scalar_mul"),
                        (aff, "chain_fwd"), (aff, "fermat_inv"), (aff, "chain_bwd_inv"),
                        (eng, "miller_loop"), (eng, "final_exp")]
        self.seen = {}
        self.saved = []

    def _sig(self, a):
        if isinstance(a, self.torch.Tensor):
            return (tuple(a.shape), a.stride())
        if isinstance(a, (tuple, list)):
            return tuple(self._sig(b) for b in a)
        return a if isinstance(a, (int, bool, float, str, type(None))) else id(a)

    def __enter__(self):
        for obj, name in self.targets:
            orig = getattr(obj, name)

            def rec(*args, _orig=orig, _name=name, **kw):
                key = (_name, self._sig(args), tuple(sorted((k, self._sig(v))
                                                            for k, v in kw.items())))
                self.seen.setdefault(key, (args, kw))
                return _orig(*args, **kw)
            self.saved.append((obj, name, orig, name in vars(obj)))
            setattr(obj, name, rec)
        return self

    def __exit__(self, *exc):
        for obj, name, orig, own in reversed(self.saved):
            if own:
                setattr(obj, name, orig)
            else:
                delattr(obj, name)
        self.saved = []

    def check(self, same, plain_add, plain_double_k):
        """Every recorded call against its plain version; returns the
        kernels' names."""
        torch, cf, pec, aff, eng = self.torch, self.cf, self.pec, self.aff, self.eng

        def shapes(a):
            if isinstance(a, torch.Tensor):
                return tuple(a.shape)
            return [shapes(b) for b in a] if isinstance(a, (tuple, list)) else a

        torch.cuda.synchronize()
        by_kind, secs = {}, {}
        for (kind, _, _), (args, kw) in self.seen.items():
            t0 = time.perf_counter()
            label = f"{shapes(args[1:] if kind == 'mont_prod' else args)} {kw or ''}"
            if kind == "mont_prod":
                got, ref = (cf.mont_prod(*args, **kw),), (cf.mont_prod_plain(*args, **kw),)
            elif kind == "add":
                got, ref = pec.add(*args), plain_add(*args)
            elif kind == "double_k":
                got, ref = pec.double_k(*args), plain_double_k(*args)
            elif kind == "miller_loop":
                got, ref = (eng.miller_loop(*args),), (eng._miller_loop_plain(*args[0], *args[1]),)
            elif kind == "final_exp":
                got, ref = (eng.final_exp(*args),), (eng._final_exp_plain(*args),)
            else:
                obj = aff if kind in ("chain_fwd", "fermat_inv", "chain_bwd_inv") else pec
                got, ref = getattr(obj, kind)(*args), getattr(obj, f"_{kind}_plain")(*args)
                if kind == "bucket_reduce":
                    got, ref = sum(got, ()), sum(ref, ())
                elif isinstance(got, torch.Tensor):
                    got, ref = (got,), (ref,)
            same(got, ref, f"{kind} at path r's shapes, {label}")
            by_kind.setdefault(kind, []).append(label)
            secs[kind] = secs.get(kind, 0.0) + time.perf_counter() - t0
        name_of = {"mont_prod": "mont_mul", "add": "ec_add", "double_k": "ec_double_k",
                   "scalar_mul": "ec_scalar_mul"}
        for kind, labels in by_kind.items():
            print(f"check {name_of.get(kind, kind)} against its plain version at path r's "
                  f"{len(labels)} distinct input shapes: exact in {secs[kind]:.1f} s "
                  f"({'; '.join(labels[:4])}{'; ...' if len(labels) > 4 else ''})", flush=True)
        return {name_of.get(k, k) for k in by_kind}


def eip2537_path(torch, np, ctx, start_path, end_path, recorder, t_main):
    """Path r: the EIP-2537 precompiles (and the two hashes) through
    models/evm_precompiles.py on the card. Builds the calldata
    (eip2537_calls), then checks every golden entry of
    tests/data/torch_evm_golden.json (its rejections too) byte for byte:
    the run of an entry that is one of path r's calls is that call's first
    timed call, the others run under `recorder`. Then profiles each call
    once under `recorder` (its output checked; its launches are the call's
    launches a call) and times it: one call where a call takes half a second
    or more (the profiled call is a second run), else three (outputs
    checked). Returns path r's seconds."""
    from constantine_tpu_torch import build
    t_start = time.perf_counter()
    names = tuple(build.KERNELS)
    ops = eip2537_ops()
    calls = eip2537_calls(np, ctx)
    entries = json.loads(EVM_GOLDEN.read_text())["entries"]
    named = {(op, data): label for label, op, data, _ in calls}
    lat = {label: [] for label, *_ in calls}

    def timed(label, fn, data):
        t0 = time.perf_counter()
        out = fn(data)
        torch.cuda.synchronize()
        lat[label].append((time.perf_counter() - t0) * 1e3)
        return out

    print(f"path r: calldata built ({time.perf_counter() - t_start:.1f} s into path r)",
          flush=True)
    start_path()
    for e in entries:
        data, fn = bytes.fromhex(e["input"]), ops[e["op"]]
        label = named.get((e["op"], data))
        if label is not None:
            got = timed(label, fn, data)
        else:
            with recorder:
                got = fn(data)
        check((None if got is None else got.hex()) == e["output"],
              f"path r golden entry {e['op']} ({e['note']}): {got and got.hex()[:32]}")
    rejected = sum(e["output"] is None for e in entries)
    print(f"path r: the {len(entries)} golden entries equal tests/data/torch_evm_golden.json "
          f"byte for byte, {rejected} of them rejections (None) "
          f"({time.perf_counter() - t_start:.1f} s into path r)", flush=True)
    per = {}
    for label, op, data, want in calls:
        fn = ops[op]
        box = []
        torch.cuda.synchronize()
        before = build.launch_counts()
        with recorder:
            prof = profile_call(torch, names, f"path r {label}", lambda: box.append(fn(data)),
                                warm=False)
        after = build.launch_counts()
        check(box[0] == want, f"path r {label}: the profiled call's output")
        per[label] = {k: after[k] - before[k] for k in after}
        ms = lat[label]
        while len(ms) < (3 if ms and ms[0] < EIP2537_CHEAP_MS else 1):
            check(timed(label, fn, data) == want, f"path r {label}: a timed call's output")
        busy = "not measured" if prof is None else f"{prof[0]:.3f} ms"
        idle = "not measured" if prof is None else f"{prof[1]:.3f}"
        launched = {k: v for k, v in per[label].items() if v}
        print(f"path r {label} ({len(data)} bytes): latency median {statistics.median(ms):.3f} "
              f"ms over {len(ms)} (min {min(ms):.3f}, max {max(ms):.3f}); device busy {busy}, "
              f"idle share {idle}; launches a call: {json.dumps(launched)}; "
              f"{time.perf_counter() - t_start:.1f} s into path r, "
              f"{time.perf_counter() - t_main:.1f} s into the smoke", flush=True)
    end_path("eip2537", None, None, per)
    return time.perf_counter() - t_start


def main():
    try:
        import numpy as np
        import torch
    except ImportError:
        print("torch and numpy are needed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False: this script needs an NVIDIA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "scripts"))
    try:
        from constantine_tpu_torch import build
        from constantine_tpu_torch.models import eip4844, peerdas
        from constantine_tpu_torch.models.kzg import get_kzg
        from constantine_tpu_torch.models.trusted_setup import DEFAULT_SETUP, get_settings
        from constantine_tpu_torch.named.precompute import get_curve
        from constantine_tpu_torch.ops import limbs as lb
        from constantine_tpu_torch.ops import msm_gpu
        from constantine_tpu_torch.ops.cuda_ec import ec_add, ec_double
        from constantine_tpu_torch.ops.cuda_field import (mont_mul, mont_mul_plain, mont_prod,
                                                          mont_prod_plain)
        from constantine_tpu_torch.ops import ntt as ntt_mod
        from constantine_tpu_torch.ops.cuda_ntt import (ntt_bfly, ntt_bfly_plain, ntt_stages,
                                                        ntt_stages_plain)
        from constantine_tpu_torch.ops.msm import (_apply_glv, _glv_for_group,
                                                   _signed_digits, msm)
        from constantine_tpu_torch.ops.ntt import bit_reversal_perm, get_domain
        from constantine_tpu_torch.models.verify_fused import get_verifier
        from constantine_tpu_torch.ops.cuda_g1 import get_cuda_g1
        from constantine_tpu_torch.ops.pairing import get_pairing
        from constantine_tpu_torch.utils import refmath as rm
        from torch_scalar_mul_teams import mul_latency, start_mul_chain
        from constantine_tpu_torch.utils.serialization import (g1_compress_affine,
                                                               g1_decompress_host,
                                                               parse_g1_host,
                                                               scalars_from_bytes)
    except ImportError as e:
        print(f"the port is not beside this script ({e})", file=sys.stderr)
        return 2
    for f in (GOLDEN, PROOF_GOLDEN, PEERDAS_GOLDEN, BLS_GOLDEN, EVM_GOLDEN):
        if not f.is_file():
            print(f"missing {f}", file=sys.stderr)
            return 2

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    t_main = time.perf_counter()
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "unknown"
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    # the lone-thread multiply chain that gives the pairing kernels' chain
    # floor, built beside the port
    chain_dir = build.BUILD_DIR / "mul_chain"
    chain_dir.mkdir(parents=True, exist_ok=True)
    chain_src, chain_nvcc = start_mul_chain(chain_dir)
    build.build_all(verbose=True)
    chain_log, _ = chain_nvcc.communicate()
    check(chain_nvcc.returncode == 0, f"the multiply chain kernel does not build:\n{chain_log}")
    print(f"kernel build: {time.perf_counter() - t0:.3f} s (nvcc, one process per source)",
          flush=True)

    ctx = get_curve("BLS12_381")
    F, g = ctx.fp, ctx.g1
    pec = g.pec
    r = ctx.r
    mul_plain = lambda a, b: mont_mul_plain(a, b, F)  # noqa: E731
    rng = torch.Generator(device="cpu").manual_seed(20261016)

    def rand_fe(n, field=F):
        ints = [int.from_bytes(bytes(torch.randint(0, 256, (48,), generator=rng).tolist()),
                               "big") % field.p_int for _ in range(n)]
        return field.encode(ints, dev)

    def planar(P):
        return tuple(v.T.contiguous() for v in P)

    def std(P):
        return tuple(v.T for v in P)

    def same(got, ref, what):
        for i, (a, b) in enumerate(zip(got, ref)):
            if not torch.equal(a, b):
                bad = (a != b).reshape(a.shape[0], -1).any(-1) if a.dim() > 1 else a != b
                raise CheckFailed(f"{what}: output {i} differs from the plain version "
                                  f"(first rows {bad.nonzero().flatten()[:8].tolist()})")

    def pass_variants(y):
        """ntt_stages' keyword sets over y (B, ns, lanes, NL): every
        combination of a load factor and a store factor (none, period 1,
        period ns * lanes; tables from the seeded generator, 0, 1 and
        r - 1 first) and the transposed store."""
        fr_ = ctx.fr
        n = y.shape[1] * y.shape[2]
        tabs = []
        for period in (None, 1, n):
            t = None if period is None else rand_fe(period, fr_)
            if t is not None and period > 2:
                t[:3] = fr_.encode([0, 1, fr_.p_int - 1], dev)
            tabs.append(t)
        return [dict(in_fac=fi, out_fac=fo, transposed=tr) for fi in tabs for fo in tabs
                for tr in (False, True)]

    def variant_name(kw):
        def per(f):
            return "-" if f is None else f"p{f.shape[0]}"
        return (f"in {per(kw.get('in_fac'))} out {per(kw.get('out_fac'))}"
                + (" transposed" if kw.get("transposed") else ""))

    def k13(g1d, xm, sign, plain=False):
        """K13 (or its plain version) with the ok bits as int32, for same()."""
        y, ok = (g1d._decompress_plain(xm, sign.bool()) if plain
                 else g1d.decompress_mont(xm, sign))
        return y, ok.to(torch.int32)

    def affine(P):
        """Jacobian point (NL,) x 3 -> host ints (x, y), or None for infinity."""
        (x, y), inf = g.to_affine(tuple(t[None] for t in P))
        return None if bool(inf[0]) else (F.decode(x)[0], F.decode(y)[0])

    path_counts = {}
    per_call = {}

    def start_path():
        torch.cuda.synchronize()
        build.reset_launch_counts()

    def end_path(name, timed_before, calls, per=None):
        """The path's launches, and its launches a call: over `calls` calls
        since `timed_before`, or `per` as given ({call: launches})."""
        torch.cuda.synchronize()
        counts = build.launch_counts()
        path_counts[name] = counts
        per_call[name] = per or {k: (counts[k] - timed_before[k]) / calls for k in counts}
        missing = [k for k in PATH_KERNELS[name] if counts[k] == 0]
        check(not missing, f"{name}: kernels of the path never launched: {missing}")
        print(f"launches on the {name} path: {json.dumps(counts)}", flush=True)

    def plain_add(P, Q):
        return planar(ec_add(F, mul_plain, std(P), std(Q)))

    def plain_double_k(P, k):
        out = std(P)
        for _ in range(k):
            out = ec_double(F, mul_plain, out)
        return planar(out)

    marks = [t_main]

    def group_done(name):
        """Print the seconds a group of the smoke took and the total so far."""
        now = time.perf_counter()
        print(f"seconds: {name} {now - marks[-1]:.1f} s ({now - t_main:.1f} s since the start)",
              flush=True)
        marks.append(now)
        return now - marks[-2]

    group_done("build")

    # ---- 1. quick checks at small shapes ------------------------------------
    for field in (F, ctx.fr):
        a, b = rand_fe(61, field), rand_fe(61, field)
        a[0] = 0
        b[1] = field.encode(field.p_int - 1, dev)
        a[2] = field.encode(field.p_int - 1, dev)
        b[2] = a[2]
        same((mont_mul(a, b, field),), (mont_mul_plain(a, b, field),), f"mont_mul {field.name}")
    # 16 distinct points 2^i * G (Jacobian, Z != 1) and their affine forms
    G = g.from_affine((F.encode([ctx.g[0]], dev), F.encode([ctx.g[1]], dev)))
    chain = [G]
    for _ in range(15):
        chain.append(g.double(chain[-1]))
    J = tuple(torch.cat([q[i] for q in chain]) for i in range(3))
    (ax, ay), _ = g.to_affine(J)
    negy = F.neg(ay)
    # add: lanes 0-7 P + Q, 8-11 P + P, 12-15 P + (-P)
    Q = tuple(torch.roll(v, 1, 0).clone() for v in J)
    for v, w in zip(Q, J):
        v[8:] = w[8:]
    Q[1][12:] = F.neg(J[1][12:])
    same(pec.add(planar(J), planar(Q)), planar(ec_add(F, mul_plain, J, Q)), "ec_add quick")
    same(pec.double_k(planar(J), 3),
         planar(ec_double(F, mul_plain, ec_double(F, mul_plain, ec_double(F, mul_plain, J)))),
         "ec_double_k quick")
    gen = torch.Generator(device="cpu").manual_seed(7)
    qk = torch.sort(torch.randint(1, 5, (8, 16), generator=gen), 0)[0].to(torch.int32).to(dev)
    qi = torch.randint(0, 32, (8, 16), generator=gen).to(dev)
    tx, ty = torch.cat([ax, ax]), torch.cat([ay, negy])          # [P ; -P]
    qst = torch.cat([tx[qi], ty[qi]], -1).permute(0, 2, 1).contiguous()   # (8, 24, 16)
    same(pec.flush_scan(qk, qst), pec._flush_scan_plain(qk, qst), "flush_scan quick")
    qk2 = qk.clone()
    qk2[5:, 3] = 0
    qj = tuple(v[qi % 16].permute(0, 2, 1).contiguous() for v in J)
    same(pec.merge_scan(qk2, *qj), pec._merge_scan_plain(qk2, *qj), "merge_scan quick")
    same(sum(pec.bucket_reduce(*(v[:4] for v in qj), 4), ()),
         sum(pec._bucket_reduce_plain(*(v[:4] for v in qj), 4), ()), "bucket_reduce quick")
    # K7 at (NL, 4), c = 3: lane 1 infinity, lane 3 Y = 0 (becomes infinity)
    P7 = planar(tuple(v[:4] for v in J))
    P7[2][:, 1] = 0
    P7[1][:, 3] = 0
    got7 = pec.scaled_doubles(P7, 3, 4)
    same(got7, pec._scaled_doubles_plain(P7, 3, 4), "scaled_doubles quick")
    check(g.is_inf(std(got7)).tolist() == [False, True, False, True],
          "scaled_doubles quick: degenerate lanes")
    # K8-K10 over Fp and Fr: chains (C = 4, Mw = 12) and both recursion levels
    # of batch_inv_packed at C = 4, block = 4 (48 -> 12 -> fermat); then
    # Field.batch_inv with zeros at chain boundaries
    for field in (F, ctx.fr):
        aff = field.affine
        x = rand_fe(48, field)
        dC = x.T.reshape(field.NL, 4, 12).transpose(0, 1).contiguous()
        pe, bp = aff.chain_fwd(dC)
        same((pe, bp), aff._chain_fwd_plain(dC), f"chain_fwd quick {field.name}")
        bi = aff.fermat_inv(bp)
        same((bi,), (aff._fermat_inv_plain(bp),), f"fermat_inv quick {field.name}")
        same((aff.chain_bwd_inv(pe, dC, bi),), (aff._chain_bwd_inv_plain(pe, dC, bi),),
             f"chain_bwd_inv quick {field.name}")
        want = [pow(v, -1, field.p_int) for v in field.decode(x)]
        check(field.decode(aff.batch_inv_packed(x.T.contiguous(), C=4, block=4).T) == want,
              f"batch_inv_packed quick {field.name}")
        z = rand_fe(70, field)
        for i in (0, 31, 32, 63, 69):
            z[i] = 0
        check(field.decode(field.batch_inv(z)) ==
              [pow(v, -1, field.p_int) if v else 0 for v in field.decode(z)],
              f"Field.batch_inv quick {field.name}")
    # K13: G1 points with both signs (lane 1 asks for the other root), an
    # on-curve point outside G1, a non-square x, and x = 0 lanes (what the
    # verifier hands over for an infinity encoding)
    g1d = get_cuda_g1()
    half = (ctx.p + 1) // 2
    pts13 = [rm.ec_mul(k, ctx.g, 0, ctx.p) for k in (1, 2, 3, 12345)]
    x_out = next(x for x in range(3, 200) if rm.sqrt_mod(x ** 3 + 4, ctx.p) is not None
                 and rm.ec_mul(r, (x, rm.sqrt_mod(x ** 3 + 4, ctx.p)), 0, ctx.p) is not None)
    x_nsq = next(x for x in range(3, 200) if rm.sqrt_mod(x ** 3 + 4, ctx.p) is None)
    y_out = rm.sqrt_mod(x_out ** 3 + 4, ctx.p)
    xs13 = [q[0] for q in pts13] + [x_out, x_nsq, 0, 0]
    sg13 = torch.tensor([q[1] >= half for q in pts13] + [y_out >= half, True, False, True],
                        device=dev)
    sg13[1] = ~sg13[1]
    xm13 = F.encode(xs13, dev)
    got13 = k13(g1d, xm13, sg13)
    same(got13, k13(g1d, xm13, sg13, plain=True), "g1_decompress quick")
    check(got13[1].tolist()[:6] == [1, 1, 1, 1, 0, 0], "g1_decompress quick: ok bits")
    # K11 on (G1, G2), (-G1, G2) and (-G1, -G2), and a batch of one; K12 on
    # f = 1 and on the three Miller outputs: the first two GT values multiply
    # to one, the third equals the first
    pr = get_pairing()
    eng, p12 = pr.engine, pr.fp12
    gx, gy = (t.to(dev) for t in ctx.g1_gen)
    g2x, g2y = (t.to(dev) for t in ctx.g2_gen)
    P11 = (torch.cat([gx, gx, gx]), torch.cat([gy, F.neg(gy), F.neg(gy)]))
    Q11 = (torch.cat([g2x, g2x, g2x]), torch.cat([g2y, g2y, F.neg(g2y[0])[None]]))
    f11 = eng.miller_loop(P11, Q11)
    same((f11,), (eng._miller_loop_plain(*P11, *Q11),), "miller_loop quick")
    P1 = tuple(t[:1] for t in P11)
    Q1 = tuple(t[:1] for t in Q11)
    same((eng.miller_loop(P1, Q1),), (eng._miller_loop_plain(*P1, *Q1),), "miller_loop B=1")
    one12 = p12.one((1,), dev)
    same((eng.final_exp(one12),), (one12,), "final_exp of one")
    gt11 = eng.final_exp(f11)
    same((gt11,), (eng._final_exp_plain(f11),), "final_exp quick")
    check(bool(p12.eq(p12.mul(gt11[:1], gt11[1:2]), one12).all()), "e(P, Q) e(-P, Q) != 1")
    check(torch.equal(gt11[2], gt11[0]), "e(-P, -Q) != e(P, Q)")
    # K3' on (2, 16, 3) with 0, 1 and r - 1 lanes, every stage (w = 1 at k = 0)
    fr = ctx.fr
    xq = rand_fe(96, fr).reshape(2, 16, 3, fr.NL)
    xq[0, 0, 0], xq[0, 1, 0], xq[1, 8, 2] = 0, fr.encode(1, dev), fr.encode(r - 1, dev)
    for h in (1, 2, 4, 8):
        twq = rand_fe(h, fr)
        twq[0] = fr.encode(1, dev)
        same((ntt_bfly(fr, xq, twq, h),), (ntt_bfly_plain(fr, xq, twq, h),),
             f"ntt_bfly quick h={h}")
    tw16 = get_domain("BLS12_381", 4).packed_twiddles(False, dev)
    brp16 = torch.as_tensor(bit_reversal_perm(16), device=dev)
    xq4 = torch.cat([xq, xq[:, :, :1]], 2).contiguous()             # (2, 16, 4)
    for xs, stages in ((xq, 4), (xq, 2), (xq4, 4)):
        same((ntt_stages(fr, xs, tw16, brp16, stages),),
             (ntt_stages_plain(fr, xs, tw16, brp16, stages),),
             f"ntt_stages quick {tuple(xs.shape[:3])} stages={stages}")
    for xs, stages in ((xq, 4), (xq, 2), (xq4, 4)):
        for kw in pass_variants(xs):
            same((ntt_stages(fr, xs, tw16, brp16, stages, **kw),),
                 (ntt_stages_plain(fr, xs, tw16, brp16, stages, **kw),),
                 f"ntt_stages quick {tuple(xs.shape[:3])} stages={stages} {variant_name(kw)}")
    print("quick checks: mont_mul (Fp, Fr), ec_add, ec_double_k, flush_scan, merge_scan, "
          "bucket_reduce, scaled_doubles, chain_fwd, fermat_inv, chain_bwd_inv (Fp, Fr), "
          "g1_decompress, miller_loop, final_exp, ntt_bfly, ntt_stages (every variant) exact "
          f"({time.perf_counter() - t_main:.1f} s since the start)", flush=True)
    group_done("quick checks")

    # ---- 2. the paths ---------------------------------------------------------------
    golden = json.loads(GOLDEN.read_text())
    blobs = {"zero": bytes(eip4844.BYTES_PER_BLOB)}
    sparse = {3: 0x1234567, 1000: r - 1, 4095: int.from_bytes(b"sparse-blob" * 2, "big") % r}
    sb = bytearray(eip4844.BYTES_PER_BLOB)
    for i, v in sparse.items():
        sb[32 * i:32 * (i + 1)] = v.to_bytes(32, "big")
    blobs["sparse"] = bytes(sb)
    for entry in golden["blobs"]:
        blob = dense_blob(entry["seed"], r)
        check(hashlib.sha256(blob).hexdigest() == entry["blob_sha256"],
              f"dense blob {entry['seed']} does not match its recipe")
        blobs[f"dense{entry['seed']}"] = blob

    tokens = Path(DEFAULT_SETUP).read_text().split()
    brp = bit_reversal_perm(4096)
    idx = sorted(sparse)
    lag, _, ok = g1_decompress_host(bytes.fromhex("".join(tokens[2 + brp[i]] for i in idx)))
    check(ok.all(), "setup points for the sparse check")
    acc = None
    for i, q in zip(idx, lag):
        acc = rm.ec_add(acc, rm.ec_mul(sparse[i], q, 0, ctx.p), 0, ctx.p)
    expected = {"zero": bytes([0xC0]) + bytes(47), "sparse": g1_compress_affine(acc)}
    for entry in golden["blobs"]:
        expected[f"dense{entry['seed']}"] = bytes.fromhex(entry["commitment"])

    # a. fixed-base commit: setup + 4 checked + 5 timed commits
    start_path()
    t0 = time.perf_counter()
    kzg = get_kzg("cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    setup_dbl = build.launch_counts()["ec_double_k"]
    for name, blob in blobs.items():
        got = eip4844.blob_to_kzg_commitment(blob, kzg)
        check(got == expected[name], f"{name} blob: commitment {got.hex() if got else got} "
                                     f"!= expected {expected[name].hex()}")
        print(f"blob {name}: commitment {got.hex()} matches", flush=True)
    before = build.launch_counts()
    lat = host_ms(torch, lambda: eip4844.blob_to_kzg_commitment(blobs["dense1"], kzg), 5)
    end_path("commit", before, 5)
    med = statistics.median(lat)
    print(f"setup (host setup load + tables on the card): {setup_s:.3f} s", flush=True)
    print(f"setup: {setup_dbl} ec_double_k launches, one a table layer ({kzg._pm.W - 1} layers "
          f"of {kzg._pm.c} doublings)", flush=True)
    check(setup_dbl == kzg._pm.W - 1, f"setup: {setup_dbl} ec_double_k launches for "
                                      f"{kzg._pm.W - 1} table layers")
    print(f"commit latency: median {med:.3f} ms over 5 (min {min(lat):.3f}, max {max(lat):.3f}); "
          f"{1e3 / med:.3f} commits/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB", flush=True)

    # b. online commit: GLV online MSM, window combine, same bytes
    torch.cuda.reset_peak_memory_stats()
    start_path()
    t0 = time.perf_counter()
    kzo = get_kzg("cuda", precompute=False)
    torch.cuda.synchronize()
    online_setup_s = time.perf_counter() - t0
    for name, blob in blobs.items():
        got = eip4844.blob_to_kzg_commitment(blob, kzo)
        check(got == expected[name], f"online {name} blob: commitment "
                                     f"{got.hex() if got else got} != expected "
                                     f"{expected[name].hex()}")
    before = build.launch_counts()
    lat = host_ms(torch, lambda: eip4844.blob_to_kzg_commitment(blobs["dense1"], kzo), 5)
    end_path("online commit", before, 5)
    med = statistics.median(lat)
    print(f"online commit (precompute=False): zero, sparse, golden blobs match; setup "
          f"{online_setup_s:.3f} s; latency median {med:.3f} ms over 5 (min {min(lat):.3f}, "
          f"max {max(lat):.3f}); {1e3 / med:.3f} commits/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB", flush=True)

    # c. batched commit of 16 blobs against the fixed-base single commits
    seeded = [dense_blob(seed, r) for seed in range(101, 113)]
    batch = list(blobs.values()) + seeded
    want = list(expected.values()) + [eip4844.blob_to_kzg_commitment(b, kzg) for b in seeded]
    torch.cuda.reset_peak_memory_stats()
    start_path()
    got = eip4844.blob_to_kzg_commitment_batch(batch, kzg)
    check(got == want, "batched commit: "
          f"{[i for i, (a, b) in enumerate(zip(got or [], want)) if a != b]} differ "
          "from the single commits")
    before = build.launch_counts()
    lat = host_ms(torch, lambda: eip4844.blob_to_kzg_commitment_batch(batch, kzg), 3)
    end_path("batch 16", before, 3)
    med = statistics.median(lat)
    print(f"batched commit of 16 (zero, sparse, 2 golden, 12 seeded): each equals its "
          f"fixed-base single commit; median {med:.3f} ms over 3 (min {min(lat):.3f}, "
          f"max {max(lat):.3f}); {16e3 / med:.3f} blobs/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB", flush=True)

    # d. online MSM at N = 2^16 over table rows, cross-checked by the
    # fixed-base commit of the folded scalars
    tabx, taby = kzg._pm._tables
    n16 = 1 << 16
    bases = (tabx[:n16], taby[:n16])
    krng = np.random.default_rng(65536)
    ks = [int.from_bytes(krng.bytes(32), "big") % r for _ in range(n16)]
    k16 = ctx.scalars_to_limbs(ks, dev)
    folded = [sum(ks[4096 * j + i] << (12 * j) for j in range(16)) % r for i in range(4096)]
    want16 = affine(kzg.commit(ctx.scalars_to_limbs(folded, dev)))
    torch.cuda.reset_peak_memory_stats()
    start_path()
    P16 = msm(g, bases, k16)
    before = build.launch_counts()
    lat = host_ms(torch, lambda: msm(g, bases, k16), 5)
    end_path("msm 2^16", before, 5)
    # the affine conversion of the check runs outside the counted window
    check(affine(P16) == want16, "msm 2^16 differs from the fixed-base cross-check")
    med = statistics.median(lat)
    print(f"online MSM N = 65536 (GLV, 255-bit scalars): equals the fixed-base cross-check; "
          f"median {med:.3f} ms over 5 (min {min(lat):.3f}, max {max(lat):.3f}); "
          f"{1e3 / med:.3f} ops/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB", flush=True)

    def report_path(name, lat, per_s, unit):
        med = statistics.median(lat)
        print(f"{name}: median {med:.3f} ms over {len(lat)} (min {min(lat):.3f}, max "
              f"{max(lat):.3f}); {per_s / med:.3f} {unit}; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB", flush=True)

    # e. prove: the golden blobs' proofs at an off-domain and an in-domain z
    proof_golden = json.loads(PROOF_GOLDEN.read_text())
    zs = {k: int(v, 16).to_bytes(32, "big") for k, v in proof_golden["z"].items()}
    pg = {e["seed"]: e for e in proof_golden["blobs"]}
    torch.cuda.reset_peak_memory_stats()
    start_path()
    for seed, entry in pg.items():
        blob = blobs[f"dense{seed}"]
        for k, zb in zs.items():
            pf, yb = eip4844.compute_kzg_proof(blob, zb, kzg)
            check((pf.hex(), yb.hex()) == (entry[f"proof_{k}"], entry[f"y_{k}"]),
                  f"compute_kzg_proof of blob {seed} at z {k}: {pf.hex()}, {yb.hex()}")
        bp = eip4844.compute_blob_kzg_proof(blob, bytes.fromhex(entry["commitment"]), kzg)
        check(bp.hex() == entry["blob_proof"], f"compute_blob_kzg_proof of blob {seed}")
    before = build.launch_counts()
    lat = host_ms(torch, lambda: eip4844.compute_kzg_proof(blobs["dense1"], zs["off"], kzg), 5)
    end_path("prove", before, 5)
    report_path("prove (compute_kzg_proof, the golden proofs and y match at both z and the "
                "blob proofs)", lat, 1e3, "proofs/s")

    # f. verify_kzg_proof on those proofs, a wrong y, a proof outside G1, a bad flag
    e1, e2 = pg[1], pg[2]
    C1, C2 = bytes.fromhex(e1["commitment"]), bytes.fromhex(e2["commitment"])
    P1, y1 = bytes.fromhex(e1["proof_off"]), bytes.fromhex(e1["y_off"])
    y1_bad = ((int.from_bytes(y1, "big") + 1) % r).to_bytes(32, "big")
    outside = g1_compress_affine((x_out, y_out))
    bad_flag = bytes([P1[0] & 0x7F]) + P1[1:]
    torch.cuda.reset_peak_memory_stats()
    start_path()
    for e in (e1, e2):
        for k, zb in zs.items():
            got = eip4844.verify_kzg_proof(bytes.fromhex(e["commitment"]), zb,
                                           bytes.fromhex(e[f"y_{k}"]),
                                           bytes.fromhex(e[f"proof_{k}"]), kzg)
            check(got is True, f"verify_kzg_proof of blob {e['seed']} at z {k}: {got}")
    check(eip4844.verify_kzg_proof(C1, zs["off"], y1_bad, P1, kzg) is False,
          "verify_kzg_proof accepts y + 1")
    for bad in (outside, bad_flag):
        check(eip4844.verify_kzg_proof(C1, zs["off"], y1, bad, kzg) is None,
              "verify_kzg_proof of a malformed proof is not None")
    before = build.launch_counts()
    lat = host_ms(torch, lambda: eip4844.verify_kzg_proof(C1, zs["off"], y1, P1, kzg), 5)
    end_path("verify", before, 5)
    report_path("verify_kzg_proof (4 True, y + 1 False, outside G1 and bad flag None)", lat,
                1e3, "verifies/s")

    # g. verify_blob_kzg_proof
    BP1, BP2 = bytes.fromhex(e1["blob_proof"]), bytes.fromhex(e2["blob_proof"])
    torch.cuda.reset_peak_memory_stats()
    start_path()
    check(eip4844.verify_blob_kzg_proof(blobs["dense1"], C1, BP1, kzg) is True,
          "verify_blob_kzg_proof of a valid proof")
    check(eip4844.verify_blob_kzg_proof(blobs["dense1"], C1, BP2, kzg) is False,
          "verify_blob_kzg_proof accepts the other blob's proof")
    before = build.launch_counts()
    lat = host_ms(torch, lambda: eip4844.verify_blob_kzg_proof(blobs["dense1"], C1, BP1, kzg),
                  5)
    end_path("verify blob", before, 5)
    report_path("verify_blob_kzg_proof (valid True, the other blob's proof False)", lat, 1e3,
                "verifies/s")

    # h. the batch verify at n = 64 (inputs made before the counted window)
    bblobs = [dense_blob(seed, r) for seed in range(301, 365)]
    bcs = eip4844.blob_to_kzg_commitment_batch(bblobs, kzg)
    bps = [eip4844.compute_blob_kzg_proof(b, c, kzg) for b, c in zip(bblobs, bcs)]
    swapped = [bps[1], bps[0]] + bps[2:]
    zf = eip4844.compute_challenge(blobs["dense1"], INF)
    yf = int.from_bytes(eip4844.compute_kzg_proof(blobs["dense1"], zf.to_bytes(32, "big"),
                                                  kzg)[1], "big")
    Pf = g1_compress_affine(rm.ec_mul(yf * pow(zf, -1, r) % r, ctx.g, 0, ctx.p))
    zero_proof = eip4844.compute_blob_kzg_proof(blobs["zero"], INF, kzg)
    check(zero_proof == INF, "the zero blob's proof is not infinity")
    torch.cuda.reset_peak_memory_stats()
    start_path()
    check(eip4844.verify_blob_kzg_proof_batch(bblobs, bcs, bps, kzg) is True,
          "verify_blob_kzg_proof_batch of 64 valid proofs")
    check(eip4844.verify_blob_kzg_proof_batch(bblobs, bcs, swapped, kzg) is False,
          "verify_blob_kzg_proof_batch accepts two swapped proofs")
    check(eip4844.verify_blob_kzg_proof_batch([blobs["dense1"]], [INF], [Pf], kzg) is False,
          "verify_blob_kzg_proof_batch accepts the F1 batch")
    check(eip4844.verify_blob_kzg_proof_batch([blobs["zero"]] + bblobs[:3],
                                              [INF] + bcs[:3], [zero_proof] + bps[:3],
                                              kzg) is True,
          "verify_blob_kzg_proof_batch of a batch with the zero blob")
    before = build.launch_counts()
    lat = host_ms(torch, lambda: eip4844.verify_blob_kzg_proof_batch(bblobs, bcs, bps, kzg), 3)
    end_path("verify batch 64", before, 3)
    report_path("verify_blob_kzg_proof_batch n = 64 (valid True, swapped False, F1 False, "
                "with the zero blob True)", lat, 64e3, "blobs/s")

    # i. compute_cells: zero blob, golden digests, two cells on the host
    pd_golden = {e["seed"]: e for e in json.loads(PEERDAS_GOLDEN.read_text())["blobs"]}
    brp12, brp13 = bit_reversal_perm(4096), bit_reversal_perm(8192)
    host_cells = {i: host_cell(blobs["dense1"], i, ctx, brp12, brp13) for i in (5, 100)}
    das_cells = peerdas.PeerDAS(get_settings("cuda"))       # no FK20 bank: cells only
    torch.cuda.reset_peak_memory_stats()
    start_path()
    check(peerdas.compute_cells(blobs["zero"], das_cells) == [bytes(2048)] * 128,
          "compute_cells of the zero blob")
    cells = {}
    for seed, entry in pd_golden.items():
        cells[seed] = peerdas.compute_cells(blobs[f"dense{seed}"], das_cells)
        check(hashlib.sha256(b"".join(cells[seed])).hexdigest() == entry["cells_sha256"],
              f"compute_cells of golden blob {seed}: digest differs")
    for i, want_cell in host_cells.items():
        check(cells[1][i] == want_cell, f"compute_cells: cell {i} differs from the host's")
    before = build.launch_counts()
    lat = host_ms(torch, lambda: peerdas.compute_cells(blobs["dense1"], das_cells), 5)
    end_path("cells", before, 5)
    report_path("compute_cells (zero blob, golden digests, host cells 5 and 100 match)", lat,
                1e3, "blobs/s")

    # j. compute_cells_and_kzg_proofs, with the PeerDAS setup
    torch.cuda.reset_peak_memory_stats()
    start_path()
    t0 = time.perf_counter()
    get_settings("cuda").g1_monomial
    srs_s = time.perf_counter() - t0
    das = peerdas.get_peerdas("cuda")
    torch.cuda.synchronize()
    pd_setup_s = time.perf_counter() - t0
    proofs = {}
    for seed, entry in pd_golden.items():
        got_cells, proofs[seed] = peerdas.compute_cells_and_kzg_proofs(blobs[f"dense{seed}"],
                                                                       das)
        check(got_cells == cells[seed], f"compute_cells_and_kzg_proofs of blob {seed}: cells")
        bad = [i for i, (a, b) in enumerate(zip(proofs[seed], entry["proofs"]))
               if a.hex() != b]
        check(not bad, f"compute_cells_and_kzg_proofs of blob {seed}: proofs {bad[:8]} differ "
                       "from the golden file")
    zc, zp = peerdas.compute_cells_and_kzg_proofs(blobs["zero"], das)
    check(zc == [bytes(2048)] * 128 and zp == [INF] * 128,
          "compute_cells_and_kzg_proofs of the zero blob")
    before = build.launch_counts()
    lat = host_ms(torch, lambda: peerdas.compute_cells_and_kzg_proofs(blobs["dense1"], das), 3)
    end_path("cells and proofs", before, 3)
    print(f"PeerDAS setup: {pd_setup_s:.3f} s, of which the monomial SRS on the host "
          f"{srs_s:.3f} s and the FK20 bank on the card {pd_setup_s - srs_s:.3f} s", flush=True)
    report_path("compute_cells_and_kzg_proofs (golden proofs match, zero blob all infinity)",
                lat, 1e3, "blobs/s")

    # k. verify_cell_kzg_proof_batch at 128 cells
    C1g, C2g = (bytes.fromhex(pg[s_]["commitment"]) for s_ in (1, 2))
    all1 = ([C1g] * 128, list(range(128)), cells[1], proofs[1])
    mixed_idx = list(range(0, 128, 2)) + list(range(1, 128, 2))
    mixed = ([C1g] * 64 + [C2g] * 64, mixed_idx,
             [cells[1][i] for i in mixed_idx[:64]] + [cells[2][i] for i in mixed_idx[64:]],
             [proofs[1][i] for i in mixed_idx[:64]] + [proofs[2][i] for i in mixed_idx[64:]])
    flipped = list(cells[1])
    flipped[17] = flipped[17][:40] + bytes([flipped[17][40] ^ 1]) + flipped[17][41:]
    swapped = [proofs[1][1], proofs[1][0]] + proofs[1][2:]
    torch.cuda.reset_peak_memory_stats()
    start_path()
    vc = peerdas.verify_cell_kzg_proof_batch
    check(vc(*all1, das) is True, "verify_cell_kzg_proof_batch of golden blob 1")
    check(vc(*mixed, das) is True, "verify_cell_kzg_proof_batch of 64 cells of each blob")
    check(vc(all1[0], all1[1], flipped, all1[3], das) is False,
          "verify_cell_kzg_proof_batch accepts a flipped cell byte")
    check(vc(all1[0], all1[1], all1[2], swapped, das) is False,
          "verify_cell_kzg_proof_batch accepts two swapped proofs")
    check(vc([INF] * 128, list(range(128)), [bytes(2048)] * 128, [INF] * 128, das) is True,
          "verify_cell_kzg_proof_batch of the zero blob's cells")
    check(vc(all1[0], [128] + all1[1][1:], all1[2], all1[3], das) is None,
          "verify_cell_kzg_proof_batch of index 128")
    check(vc(all1[0], all1[1], [cells[1][0][:-1]] + cells[1][1:], all1[3], das) is None,
          "verify_cell_kzg_proof_batch of a 2047-byte cell")
    before = build.launch_counts()
    lat = host_ms(torch, lambda: vc(*all1, das), 5)
    end_path("verify cells", before, 5)
    report_path("verify_cell_kzg_proof_batch of 128 cells (blob 1 True, 64 + 64 True, flipped "
                "False, swapped False, zero blob True, index 128 and 2047 bytes None)", lat,
                128e3, "cells/s")

    # l. recover_cells_and_kzg_proofs
    half_idx = list(range(0, 128, 2))
    torch.cuda.reset_peak_memory_stats()
    start_path()
    rc = peerdas.recover_cells_and_kzg_proofs
    check(rc(half_idx, [cells[1][i] for i in half_idx], das) == (cells[1], proofs[1]),
          "recover_cells_and_kzg_proofs from every other cell")
    check(rc(list(range(128)), cells[1], das) == (cells[1], proofs[1]),
          "recover_cells_and_kzg_proofs from all cells")
    check(rc(half_idx[:63], [cells[1][i] for i in half_idx[:63]], das) is None,
          "recover_cells_and_kzg_proofs from 63 cells")
    before = build.launch_counts()
    lat = host_ms(torch, lambda: rc(half_idx, [cells[1][i] for i in half_idx], das), 3)
    end_path("recover", before, 3)
    report_path("recover_cells_and_kzg_proofs from 64 cells (64 and 128 cells match path j, 63 "
                "None)", lat, 1e3, "recoveries/s")

    # m. the NTT at 2^16: the four-step (2-D input) against the radix-2 route
    # (a batch of one: 12 stages a pass, 4 ntt_bfly launches, 1/n a K1 product)
    fr = ctx.fr
    dom16 = get_domain("BLS12_381", 16)
    raw16 = np.random.default_rng(65536).bytes(32 * 65536)
    xn16 = fr.to_mont(lb.to_tensor(lb.ints_to_limbs(
        [int.from_bytes(raw16[32 * i:32 * i + 32], "big") % r for i in range(65536)], fr.NL),
        dev))
    torch.cuda.reset_peak_memory_stats()
    start_path()
    f16, i16 = dom16.ntt(xn16), dom16.intt(xn16)
    check(torch.equal(f16, dom16.ntt(xn16[None])[0]), "ntt 2^16: four-step != radix-2")
    check(torch.equal(i16, dom16.intt(xn16[None])[0]), "intt 2^16: four-step != radix-2")
    check(torch.equal(dom16.intt(f16), xn16), "intt(ntt(x)) != x at 2^16")
    before = build.launch_counts()
    lat = host_ms(torch, lambda: dom16.ntt(xn16), 5)
    lat_i = host_ms(torch, lambda: dom16.intt(xn16), 5)
    end_path("ntt 2^16", before, 5)
    report_path("NTT n = 2^16, four-step (equal to the radix-2 route, intt(ntt) = x)", lat,
                1e3, "ntts/s")
    report_path("iNTT n = 2^16, four-step", lat_i, 1e3, "intts/s")

    # a four-step and a coset transform are two ntt_stages launches and two
    # allocations (the passes' outputs), nothing else
    dom13 = get_domain("BLS12_381", 13)
    x13 = xn16[:8192].contiguous()
    for label, fn in (("ntt 8192", lambda: dom13.ntt(x13)), ("intt 8192", lambda: dom13.intt(x13)),
                      ("coset_ntt 8192", lambda: dom13.coset_ntt(x13, 7)),
                      ("coset_intt 8192", lambda: dom13.coset_intt(x13, 7))):
        fn()
        torch.cuda.synchronize()
        build.reset_launch_counts()
        allocs = torch.cuda.memory_stats()["allocation.all.allocated"]
        fn()
        allocs = torch.cuda.memory_stats()["allocation.all.allocated"] - allocs
        launched = {k: v for k, v in build.launch_counts().items() if v}
        check(launched == {"ntt_stages": 2} and allocs == 2,
              f"{label}: launches {launched}, {allocs} allocations (two ntt_stages, two)")
    print("check a four-step and a coset transform of 8192, forward and inverse: two "
          "ntt_stages launches and two allocations each, nothing else", flush=True)

    group_done("paths a-m (KZG, PeerDAS, the NTT)")
    # n-q. BLS signatures: sign 64, verify 64, the 512-key sync committee, a
    # block of 128 attestations
    freed_s = bls_paths(torch, np, ctx, dev, start_path, end_path, per_call)
    group_done("paths n-q (BLS signatures)")
    # r. EIP-2537
    r_inputs = KernelInputs(torch, ctx)
    r_s = eip2537_path(torch, np, ctx, start_path, end_path, r_inputs, t_main)
    group_done("path r (EIP-2537)")

    for name in PATH_KERNELS:
        print(f"launches per call, {name}: {json.dumps(per_call[name])}", flush=True)
    k1_calls = {name: per_call[name]["mont_mul"] for name in PATH_KERNELS if name != "eip2537"}
    print(f"K1 (mont_mul, one launch a product chain) launches per call on paths a-q: "
          f"{json.dumps(k1_calls)}, total {sum(k1_calls.values())}", flush=True)
    check(all(k1_calls[k] <= v for k, v in K1_LAUNCHES.items()),
          f"K1 launches per call {k1_calls}, above {K1_LAUNCHES}")
    k1_r = {label: c["mont_mul"] for label, c in per_call["eip2537"].items()}
    print(f"K1 launches per call on path r: {json.dumps(k1_r)}", flush=True)
    check(k1_r.keys() == EIP2537_K1.keys() and all(k1_r[k] <= v for k, v in EIP2537_K1.items()),
          f"path r's K1 launches per call {k1_r}, above {EIP2537_K1}")
    for name in ("cells and proofs", "recover"):
        got = {k: per_call[name][k] for k in FK20_LAUNCHES}
        check(got == FK20_LAUNCHES, f"{name}: launches per call {got}, not {FK20_LAUNCHES}")
    stage_calls = {name: per_call[name]["ntt_stages"] + per_call[name]["ntt_bfly"]
                   for name in STAGE_LAUNCHES}
    print(f"K3' stage launches (ntt_stages + ntt_bfly) per call: {json.dumps(stage_calls)}",
          flush=True)
    check(all(stage_calls[k] <= v for k, v in STAGE_LAUNCHES.items()),
          f"K3' stage launches per call {stage_calls}, above {STAGE_LAUNCHES}")
    bfly_calls = {name: path_counts[name]["ntt_bfly"] for name in NO_BFLY}
    check(not any(bfly_calls.values()), f"ntt_bfly launched on paths i-l: {bfly_calls}")
    total = {k: sum(c[k] for c in path_counts.values()) for k in build.KERNELS}
    check(all(v > 0 for v in total.values()), f"a kernel never launched: {total}")

    names = tuple(build.KERNELS)
    profile_call(torch, names, "commit",
                 lambda: eip4844.blob_to_kzg_commitment(blobs["dense1"], kzg))
    profile_call(torch, names, "online commit",
                 lambda: eip4844.blob_to_kzg_commitment(blobs["dense1"], kzo))
    profile_call(torch, names, "batch of 16",
                 lambda: eip4844.blob_to_kzg_commitment_batch(batch, kzg))
    profile_call(torch, names, "msm 2^16", lambda: msm(g, bases, k16))
    profile_call(torch, names, "prove",
                 lambda: eip4844.compute_kzg_proof(blobs["dense1"], zs["off"], kzg))
    profile_call(torch, names, "verify",
                 lambda: eip4844.verify_kzg_proof(C1, zs["off"], y1, P1, kzg))
    profile_call(torch, names, "verify blob",
                 lambda: eip4844.verify_blob_kzg_proof(blobs["dense1"], C1, BP1, kzg))
    profile_call(torch, names, "verify batch 64",
                 lambda: eip4844.verify_blob_kzg_proof_batch(bblobs, bcs, bps, kzg))
    profile_call(torch, names, "compute_cells",
                 lambda: peerdas.compute_cells(blobs["dense1"], das_cells))
    profile_call(torch, names, "FK20 bank (PeerDAS setup)",
                 lambda: peerdas.PeerDAS(get_settings("cuda")).bank)
    profile_call(torch, names, "compute_cells_and_kzg_proofs",
                 lambda: peerdas.compute_cells_and_kzg_proofs(blobs["dense1"], das))
    profile_call(torch, names, "verify_cell_kzg_proof_batch of 128",
                 lambda: peerdas.verify_cell_kzg_proof_batch(*all1, das))
    profile_call(torch, names, "recover from 64",
                 lambda: peerdas.recover_cells_and_kzg_proofs(
                     half_idx, [cells[1][i] for i in half_idx], das))

    # ---- 3. every kernel against its plain version at the paths' shapes --------
    report = {}

    def record(name, got, ref, kernel_fn, plain_fn, nbytes, nmuls, reps, label=None,
               keep=True, mul_ops=MUL_OPS):
        label = label or name
        same(got, ref, label)
        ms = cuda_ms(torch, kernel_fn, reps)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain_fn()
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        bms, by = bound(nbytes, nmuls, mul_ops)
        if keep:
            report[name] = dict(max_abs_err=max_abs_err(lb, got, ref), ms=ms,
                                plain_ms=plain_ms, bound_ms=bms, bound_by=by)
        print(f"check {label}: exact; kernel {ms:.4f} ms, plain {plain_ms:.1f} ms, "
              f"bound {bms:.6f} ms ({by})", flush=True)
        return ms

    poly, _ = eip4844.blob_to_polynomial(blobs["dense1"])
    digits = _signed_digits(lb.to_tensor(poly, dev), kzg._pm.c, kzg._pm.W).reshape(1, -1)
    fs = msm_gpu._flush_stream(F, (tabx, taby), digits, kzg._pm.c)

    # K1 at the paths' widths: the setup's to_affine multiplies all (W-1)*4096
    # shifted table points, the exports one point and 16. Inputs: the table
    # itself, with 0, 1 and p-1 lanes.
    n1 = tabx.shape[0] - 4096
    a, b = tabx[4096:].clone(), taby[4096:].clone()
    a[0], b[1] = 0, F.encode(1, dev)
    a[2] = b[2] = F.encode(F.p_int - 1, dev)
    for n in (1, 16):
        same((mont_mul(a[:n], b[:n], F),), (mont_mul_plain(a[:n], b[:n], F),),
             f"mont_mul n={n}")
    record("mont_mul", (mont_mul(a, b, F),), (mont_mul_plain(a, b, F),),
           lambda: mont_mul(a, b, F), lambda: mont_mul_plain(a, b, F),
           3 * n1 * FE_BYTES, n1, reps=50)
    k1_dev = device_ms(torch, lambda: mont_mul(a, b, F), 50)
    print(f"mont_mul n={n1}: device {k1_dev} ms a call (calls queued behind a sleep)",
          flush=True)
    # K1's chains: m = 1-4 factors, k = 0 or 12 squarings, factor j of period
    # n, 4,096 (a row of the blobs' axis: the roots), 1 (a constant) or n, over
    # Fr at two blobs (n = 8,192) and Fp at the same shape; 0, 1 and p - 1 in
    # the full operands, and the 4,096 operand also expanded (stride 0)
    for field in (fr, F):
        c0, c1 = (rand_fe(2 * 4096, field).reshape(2, 4096, field.NL) for _ in range(2))
        c0[0, :3] = field.encode([0, 1, field.p_int - 1], dev)
        c1[1, 7:10] = field.encode([field.p_int - 1, 0, 1], dev)
        c_row = rand_fe(4096, field)
        c_const = rand_fe(1, field)[0]
        c_rowe = c_row.expand(2, 4096, field.NL)
        for cm, ck, cfs in ((1, 12, (c0,)), (2, 0, (c0, c_row)), (2, 12, (c_rowe, c1)),
                            (3, 0, (c0, c_rowe, c_const)), (3, 12, (c_const, c1, c_row)),
                            (4, 0, (c0, c_row, c_const, c1)),
                            (4, 12, (c1, c_const, c_rowe, c0))):
            same((mont_prod(field, *cfs, squarings=ck),),
                 (mont_prod_plain(field, *cfs, squarings=ck),),
                 f"mont_prod {field.name} m={cm} k={ck}")
    print("check mont_prod over Fr and Fp, m = 1-4, k = 0 and 12, periods n, 4,096 (also "
          "expanded) and 1, with 0, 1 and p - 1 lanes: exact", flush=True)
    # K1 a call, through the wrapper: n = 1, 16, 4,096 (m = 2) and z^N (Fr,
    # m = 1, k = 12): host clock, synchronised, and the device's time
    zq = rand_fe(1, fr)
    for k1_label, k1_fn in ([(f"mont_mul n={n}", lambda n=n: mont_mul(a[:n], b[:n], F))
                             for n in (1, 16, 4096)]
                            + [("mont_prod z^N (Fr, n=1, k=12)",
                                lambda: mont_prod(fr, zq, squarings=12))]):
        k1_call = statistics.median(host_ms(torch, k1_fn, 50))
        print(f"{k1_label}: a call {k1_call:.4f} ms (host clock, synchronised), enqueued "
              f"{enqueue_ms(torch, k1_fn, 50):.4f} ms (back to back), device "
              f"{device_ms(torch, k1_fn, 50)} ms", flush=True)

    # K3 double at the precompute's width: k = 1 and a table layer's k = 12,
    # Jacobian table points (Z != 1) with an infinity lane and a Y = 0 lane
    nd = 4096
    Pd = g.double(g.from_affine((tabx[:nd], taby[:nd])))
    Pd[2][0] = 0
    Pd[1][1] = 0
    Pp = planar(Pd)

    def double_plain(P, k):
        for _ in range(k):
            P = ec_double(F, mul_plain, P)
        return P

    dk_ms = {}

    def dk_check(P, k, label, keep):
        """K3 double_k at (NL, n) points P and k against the plain chain;
        its call and device time."""
        n = P[0].shape[1]
        call = record(
            "ec_double_k", pec.double_k(P, k), planar(double_plain(std(P), k)),
            lambda: pec.double_k(P, k), lambda: double_plain(std(P), k), 6 * n * FE_BYTES,
            MULS["double"] * k * (~F.is_zero(P[2].T)).sum().item(), reps=20,
            label=f"ec_double_k n={n} k={k} {label}", keep=keep)
        dk_ms[n, k] = call, device_ms(torch, lambda: pec.double_k(P, k), 20)

    dk_check(Pp, 1, "(infinity and Y = 0 lanes)", False)
    dk_check(Pp, 12, "(a table layer; infinity and Y = 0 lanes)", True)
    check(g.is_inf(std(pec.double_k(Pp, 12)))[:3].tolist() == [True, True, False],
          "ec_double_k: infinity and Y = 0 lanes")

    def scan_checks(fs, n_pts, c, W, tag, keep):
        """K4, K5 and K6 against their plain versions on one path's stream:
        the flush scan over its sorted stream, the first merge scan over the
        compacted flush, bucket_reduce over its bucket planes. Returns the
        bucket planes and T."""
        K, M, nb = fs.K, fs.M, fs.nb
        # K4, lanes 0-2 rebuilt: one run of [P, -P, Q, Q, ...] (infinity,
        # then a fresh point, then a doubling), a padding lane, and one run
        # over all K of the lane's own entries
        keys, st = fs.skT.clone(), fs.st.clone()
        keys[:, 0] = keys[0, 0]
        st[1, :NL, 0], st[1, NL:, 0] = st[0, :NL, 0], F.neg(st[0, NL:, 0][None])[0]
        st[3, :, 0] = st[2, :, 0]
        keys[:, 1] = nb + 1
        st[:, :, 1] = st[0, :, 2][None]
        keys[:, 2] = keys[0, 2]
        run_same = (keys[1:] == keys[:-1]).sum().item()
        record("flush_scan", pec.flush_scan(keys, st), pec._flush_scan_plain(keys, st),
               lambda: pec.flush_scan(keys, st), lambda: pec._flush_scan_plain(keys, st),
               K * M * (4 + 2 * FE_BYTES + 3 * FE_BYTES), MULS["madd"] * run_same, reps=5,
               label=f"flush_scan {tag} K={K} M={M}", keep=keep)

        # K5 on the first merge input; lane 0: [P, P], lane 1: [P, -P],
        # lane 2: [inf, P] under one key
        ex, ey, ez = pec.flush_scan(fs.skT, fs.st)
        kT, xT, yT, zT, M2 = msm_gpu._compact_boundaries(pec, fs.sk, fs.skT, (ex, ey, ez),
                                                         K, M, nb, fs.H, 32)
        kT, xT, yT, zT = (v.clone() for v in (kT, xT, yT, zT))
        for lane in (0, 1, 2):
            kT[:2, lane] = 7
            for v in (xT, yT, zT):
                v[1, :, lane] = v[0, :, lane]
        yT[1, :, 1] = F.neg(yT[1, :, 1][None])[0]
        zT[0, :, 2] = 0
        want5 = pec._merge_scan_plain(kT, xT, yT, zT)
        record("merge_scan", pec.merge_scan(kT, xT, yT, zT), want5,
               lambda: pec.merge_scan(kT, xT, yT, zT),
               lambda: pec._merge_scan_plain(kT, xT, yT, zT),
               kT.numel() * (4 + 6 * FE_BYTES), MULS["add"] * merge_work(kT, zT, want5[2])[1],
               reps=20, label=f"merge_scan {tag} K2=32 M2={M2} (degenerate lanes 0-2)",
               keep=keep)

        # K6 on the bucket planes; lane 0: B1 = B0, lane 1: B1 = -B0,
        # lane 2: B2 = infinity
        e2 = pec.merge_scan(kT, xT, yT, zT)
        rounds = msm_gpu._cdiv(msm_gpu._cdiv(n_pts, K) + 1, 32) + 1
        ck, cx, cy, cz = msm_gpu._merge_rounds(pec, kT, *e2, 32, M2, nb, fs.H, rounds, 32)
        cx, cy, cz = msm_gpu._tree_rounds(pec, ck, cx, cy, cz)
        planes, T, C = msm_gpu._bucket_planes(ck, cx, cy, cz, c, W, fs.H)
        bx, by, bz = (v.clone() for v in planes)
        for v in (bx, by, bz):
            v[1, :, 0] = v[0, :, 0]
            v[1, :, 1] = v[0, :, 1]
        by[1, :, 1] = F.neg(by[1, :, 1][None])[0]
        bz[2, :, 2] = 0
        k6_check(bx, by, bz, T, f"{tag} (degenerate lanes 0-2)", keep)
        return (bx, by, bz), T

    def k6_check(bx, by, bz, T, tag, keep):
        """K6 against its plain version, timed beside its bound: the adds with
        both operands finite (an add with infinity is a select; step t adds
        run into wsum, then bucket t into run)."""
        fin = ~F.is_zero(bz.transpose(1, 2))                           # (T, lanes)
        no = torch.zeros_like(fin[:1])
        run_fin = torch.cat([no, fin.cumsum(0)[:-1] > 0])               # run before step t
        wsum_fin = torch.cat([no, run_fin.cumsum(0)[:-1] > 0])
        n_adds = ((run_fin & fin).sum() + (wsum_fin & run_fin).sum()).item()
        lanes = bx.shape[2]
        k6_in[T, lanes] = bx, by, bz
        k6_ms[T, lanes] = record(
            "bucket_reduce", sum(pec.bucket_reduce(bx, by, bz, T), ()),
            sum(pec._bucket_reduce_plain(bx, by, bz, T), ()),
            lambda: pec.bucket_reduce(bx, by, bz, T),
            lambda: pec._bucket_reduce_plain(bx, by, bz, T),
            lanes * (3 * T + 6) * FE_BYTES, MULS["add"] * n_adds, reps=20,
            label=f"bucket_reduce {tag} T={T} lanes={lanes}", keep=keep)

    # the fixed-base commit's stream (its numbers go into the kernels' line),
    # then the online commit's: the GLV split of the setup points, c = 9, W = 15
    k6_ms, k6_in = {}, {}
    (bx, by, bz), T = scan_checks(fs, tabx.shape[0], kzg._pm.c, 1, "commit", True)
    glv_pts, glv_k, glv_bits = _apply_glv(g, _glv_for_group(g.name), kzo.s.g1_lagrange_brp,
                                          lb.to_tensor(poly, dev))
    n_o = glv_pts[0].shape[0]
    c_o = msm_gpu.best_window_tpu(n_o, glv_bits)
    W_o = msm_gpu._cdiv(glv_bits + 1, c_o)
    fso = msm_gpu._flush_stream(F, glv_pts, _signed_digits(glv_k, c_o, W_o), c_o)
    scan_checks(fso, n_o, c_o, W_o, f"online commit c={c_o} W={W_o}", False)
    C = bx.shape[2]

    # K4 at the batch of 16 (K = 1,472, M = 1,024) over 16 dense blobs and
    # over 16 zero blobs (every lane one run of the gap key: the worst case),
    # and at the 2^16 MSM (K = 1,408): held once against the plain version
    # (~25 s a call at these K), then timed beside its bound.
    def batch_stream(blob_list):
        """blob_to_kzg_commitment_batch's flush stream (PrecomputedMSM.batch)."""
        pm = kzg._pm
        polys = lb.to_tensor(np.stack([eip4844.blob_to_polynomial(b)[0] for b in blob_list]),
                             dev)
        B, N, NLr = polys.shape
        rows = _signed_digits(polys.reshape(B * N, NLr), pm.c, pm.W)
        rows = rows.reshape(pm.W, B, N).transpose(0, 1).reshape(B, pm.W * N)
        return msm_gpu._flush_stream(F, pm._tables, rows, pm.c)

    glv_p, glv_s, glv_b = _apply_glv(g, _glv_for_group(g.name), bases, k16)
    c16 = msm_gpu.best_window_tpu(glv_p[0].shape[0], glv_b)
    W16 = msm_gpu._cdiv(glv_b + 1, c16)
    k4_streams = {
        "batch 16 dense": batch_stream(seeded + [dense_blob(s_, r) for s_ in range(113, 117)]),
        "msm 2^16": msm_gpu._flush_stream(F, glv_p, _signed_digits(glv_s, c16, W16), c16),
        "batch 16 zero blobs": batch_stream([blobs["zero"]] * 16),
    }
    for label, st4 in k4_streams.items():
        K4, M4, keys4, xy4 = st4.K, st4.M, st4.skT, st4.st
        got4 = pec.flush_scan(keys4, xy4)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want4 = pec._flush_scan_plain(keys4, xy4)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        same(got4, want4, f"flush_scan {label} K={K4} M={M4}")
        del got4, want4
        ms4 = cuda_ms(torch, lambda: pec.flush_scan(keys4, xy4), 5)
        madds = (keys4[1:] == keys4[:-1]).sum().item()
        bms4, by4 = bound(K4 * M4 * (4 + 5 * FE_BYTES), MULS["madd"] * madds)
        print(f"check flush_scan {label} K={K4} M={M4}: exact (plain {plain_s:.1f} s); "
              f"kernel {ms4:.4f} ms a call (CUDA events), bound {bms4:.6f} ms ({by4}); "
              f"{madds} madds, longest run {longest_run(keys4)} steps", flush=True)
    del k4_streams

    # K5 at every merge stream the paths feed it, recorded from the entry
    # points (the fixed-base commit's two rounds, the online commit, the
    # batch of 16 dense blobs, the 2^16 MSM, 16 zero blobs): exact against
    # the plain version, then timed beside its bound (the adds that need
    # products: the key stays, > 0, and neither side is infinity)
    dense16 = seeded + [dense_blob(s_, r) for s_ in range(113, 117)]
    merge_calls = (
        ("commit", lambda: eip4844.blob_to_kzg_commitment(blobs["dense1"], kzg)),
        ("online commit", lambda: eip4844.blob_to_kzg_commitment(blobs["dense1"], kzo)),
        ("batch 16 dense", lambda: eip4844.blob_to_kzg_commitment_batch(dense16, kzg)),
        ("msm 2^16", lambda: msm(g, bases, k16)),
        ("batch 16 zero blobs", lambda: eip4844.blob_to_kzg_commitment_batch(
            [blobs["zero"]] * 16, kzg)))
    for label, fn in merge_calls:
        recorded = record_merges(pec, fn)
        check(recorded, f"{label}: no merge_scan call recorded")
        for rnd, (kM, xM, yM, zM) in enumerate(recorded, 1):
            K2, M2 = kM.shape
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want5 = pec._merge_scan_plain(kM, xM, yM, zM)
            torch.cuda.synchronize()
            plain5 = (time.perf_counter() - t0) * 1e3
            same(pec.merge_scan(kM, xM, yM, zM), want5,
                 f"merge_scan {label} round {rnd} K2={K2} M2={M2}")
            ms5 = cuda_ms(torch, lambda: pec.merge_scan(kM, xM, yM, zM), 20)
            longest, adds, lane_max, run_max = merge_work(kM, zM, want5[2])
            bms5, by5 = bound(kM.numel() * (4 + 6 * FE_BYTES), MULS["add"] * adds)
            print(f"check merge_scan {label} round {rnd} K2={K2} M2={M2}: exact (plain "
                  f"{plain5:.1f} ms); kernel {ms5:.4f} ms a call (CUDA events), bound "
                  f"{bms5:.6f} ms ({by5}); longest run {longest} (key > 0), {adds} adds with "
                  f"products, at most {lane_max} a lane and {run_max} a run", flush=True)

    # K6 at every (T, lanes) the MSM paths reach, recorded from the entry
    # points (the commit and proving: T = 4 over 512 lanes; the online
    # commit: 4 over 960; the 2^16 MSM: 8 over 2,816; the batch of 16: 16
    # over 2,048; the two batch verifies' online MSMs), with lane 0 B1 = B0,
    # lane 1 B1 = -B0 and lane 2 B2 at infinity
    k6_calls = (
        ("commit", lambda: eip4844.blob_to_kzg_commitment(blobs["dense1"], kzg)),
        ("online commit", lambda: eip4844.blob_to_kzg_commitment(blobs["dense1"], kzo)),
        ("batch 16", lambda: eip4844.blob_to_kzg_commitment_batch(batch, kzg)),
        ("msm 2^16", lambda: msm(g, bases, k16)),
        ("prove", lambda: eip4844.compute_kzg_proof(blobs["dense1"], zs["off"], kzg)),
        ("verify batch 64", lambda: eip4844.verify_blob_kzg_proof_batch(bblobs, bcs, bps, kzg)),
        ("verify cells", lambda: peerdas.verify_cell_kzg_proof_batch(*all1, das)))
    for label, fn in k6_calls:
        recorded = record_calls(pec, "bucket_reduce", fn)
        check(recorded, f"{label}: no bucket_reduce call recorded")
        for b6x, b6y, b6z, T6 in recorded:
            if (T6, b6x.shape[2]) in k6_ms:
                continue
            for v in (b6x, b6y, b6z):
                v[1, :, 0] = v[0, :, 0]
                v[1, :, 1] = v[0, :, 1]
            b6y[1, :, 1] = F.neg(b6y[1, :, 1][None])[0]
            b6z[2, :, 2] = 0
            k6_check(b6x, b6y, b6z, T6, f"{label} (degenerate lanes 0-2)", False)

    # K3 double at every (n, k) the MSM tails reach (log2 T doublings of the
    # windows' lane 0), recorded from the same entry points, with lane 1 at
    # infinity and lane 3 with Y = 0 where the call has them
    for label, fn in k6_calls:
        recorded = record_calls(pec, "double_k", fn)
        check(recorded, f"{label}: no double_k call recorded")
        for P3, k3 in recorded:
            if (P3[0].shape[1], k3) in dk_ms:
                continue
            if P3[0].shape[1] > 1:
                P3[2][:, 1] = 0
            if P3[0].shape[1] > 3:
                P3[1][:, 3] = 0
            dk_check(P3, k3, f"({label}'s tail)", False)

    # K3 add at the tail's width (C = 512 chunk lanes), with P == Q, P == -Q,
    # infinity on either side, and P == Q under another Z
    run, _ = pec.bucket_reduce(bx, by, bz, T)
    Pa = std(run)
    Qa = tuple(torch.roll(v, -1, 0).clone() for v in Pa)
    lam = rand_fe(1)
    lam2 = F.mul(lam, lam)
    for v, w in zip(Qa, Pa):
        v[0] = w[0]
    Qa[1][1] = F.neg(Pa[1][1][None])[0]
    Qa[0][1], Qa[2][1] = Pa[0][1], Pa[2][1]
    Pa[2][2] = 0
    Qa[2][3] = 0
    Pa[2][4] = Qa[2][4] = 0
    Qa[0][5] = F.mul(Pa[0][5][None], lam2)[0]
    Qa[1][5] = F.mul(Pa[1][5][None], F.mul(lam2, lam))[0]
    Qa[2][5] = F.mul(Pa[2][5][None], lam)[0]
    Pp, Qp = planar(Pa), planar(Qa)
    finite = (~(F.is_zero(Pa[2]) | F.is_zero(Qa[2]))).sum().item()
    record("ec_add", pec.add(Pp, Qp), planar(ec_add(F, mul_plain, Pa, Qa)),
           lambda: pec.add(Pp, Qp), lambda: ec_add(F, mul_plain, Pa, Qa),
           9 * C * FE_BYTES, MULS["add"] * finite, reps=50)
    inf_lanes = g.is_inf(std(pec.add(Pp, Qp)))
    check(bool(inf_lanes[1]) and bool(inf_lanes[4]) and not bool(inf_lanes[5]),
          "ec_add degenerate lanes")

    def add_times(label, Pn, Qn, call_ms):
        dms = device_ms(torch, lambda: pec.add(Pn, Qn), 50)
        hms = enqueue_ms(torch, lambda: pec.add(Pn, Qn), 200)
        print(f"ec_add {label}: call {call_ms:.4f} ms (CUDA events over back-to-back calls), "
              f"device {'not measured' if dms is None else f'{dms:.4f} ms'} a launch "
              f"(CUDA events, queued behind a sleep), host {hms:.4f} ms to return a call",
              flush=True)

    add_times(f"{C} lanes (the tail)", Pp, Qp, report["ec_add"]["ms"])

    # K7 at the online commit's (NL, 15), c = 9 and the 2^16 MSM's (NL, 11),
    # c = 12; inputs: Jacobian table points (Z != 1), lane 1 at infinity and
    # lane 3 with Y = 0 (both infinity out)
    k7_ms = {}
    for W7, c7, keep in ((15, 9, True), (11, 12, False)):
        P7 = planar(g.double(g.from_affine((tabx[:W7], taby[:W7]))))
        P7[2][:, 1] = 0
        P7[1][:, 3] = 0
        check(g.is_inf(std(pec.scaled_doubles(P7, c7, W7))).tolist()
              == [w in (1, 3) for w in range(W7)], f"scaled_doubles W={W7}: degenerate lanes")
        k7_ms[W7, c7] = record(
            "scaled_doubles", pec.scaled_doubles(P7, c7, W7),
            pec._scaled_doubles_plain(P7, c7, W7), lambda: pec.scaled_doubles(P7, c7, W7),
            lambda: pec._scaled_doubles_plain(P7, c7, W7), 6 * W7 * FE_BYTES,
            MULS["double"] * c7 * W7 * (W7 - 1) // 2, reps=5,
            label=f"scaled_doubles W={W7} c={c7}", keep=keep)

    # K8, K10 at the setup's to_affine: 90,112 Z values padded with ones to
    # 98,304 = 32 chains x 3,072 lanes (here the table's x coordinates);
    # K9 at 512 lanes (the setup's second level), 16 (the batch export), 1
    # (every commit's export)
    aff = F.affine
    C8, blk = 32, 512
    m8 = msm_gpu._rup(n1, C8 * blk)
    xs = torch.cat([tabx[4096:], F.broadcast_one((m8 - n1,), dev)])
    Mw = m8 // C8
    dC = xs.T.reshape(NL, C8, Mw).transpose(0, 1).contiguous()
    record("chain_fwd", aff.chain_fwd(dC), aff._chain_fwd_plain(dC),
           lambda: aff.chain_fwd(dC), lambda: aff._chain_fwd_plain(dC),
           (2 * C8 + 1) * Mw * FE_BYTES, C8 * Mw, reps=20,
           label=f"chain_fwd C={C8} Mw={Mw}")
    print(f"chain_fwd C={C8} Mw={Mw}: device "
          f"{device_ms(torch, lambda: aff.chain_fwd(dC), 20)} ms", flush=True)
    pe, bp = aff.chain_fwd(dC)
    bpinv = aff.batch_inv_packed(bp)
    record("chain_bwd_inv", (aff.chain_bwd_inv(pe, dC, bpinv),),
           (aff._chain_bwd_inv_plain(pe, dC, bpinv),),
           lambda: aff.chain_bwd_inv(pe, dC, bpinv),
           lambda: aff._chain_bwd_inv_plain(pe, dC, bpinv),
           (3 * C8 + 1) * Mw * FE_BYTES, 2 * C8 * Mw, reps=20,
           label=f"chain_bwd_inv C={C8} Mw={Mw}")
    print(f"chain_bwd_inv C={C8} Mw={Mw}: device "
          f"{device_ms(torch, lambda: aff.chain_bwd_inv(pe, dC, bpinv), 20)} ms", flush=True)
    # K8 and K10 at the paths' Fr chains: Field.batch_inv of 4,096 or 8,192
    # lanes padded to 16,384 (Mw = 512), and the batch verify's 262,144 (8,192)
    for Mw10 in (512, 8192):
        pe10, d10 = (rand_fe(C8 * Mw10, fr).T.reshape(fr.NL, C8, Mw10).transpose(0, 1)
                     .contiguous() for _ in range(2))
        bi10 = rand_fe(Mw10, fr).T.contiguous()
        k8 = lambda: fr.affine.chain_fwd(d10)  # noqa: E731
        record("chain_fwd", k8(), fr.affine._chain_fwd_plain(d10), k8,
               lambda: fr.affine._chain_fwd_plain(d10), (2 * C8 + 1) * Mw10 * 4 * fr.NL,
               C8 * Mw10, reps=20, keep=False, label=f"chain_fwd Fr C={C8} Mw={Mw10}",
               mul_ops=FR_MUL_OPS)
        print(f"chain_fwd Fr C={C8} Mw={Mw10}: device {device_ms(torch, k8, 20)} ms",
              flush=True)
        k10 = lambda: fr.affine.chain_bwd_inv(pe10, d10, bi10)  # noqa: E731
        record("chain_bwd_inv", (k10(),), (fr.affine._chain_bwd_inv_plain(pe10, d10, bi10),),
               k10, lambda: fr.affine._chain_bwd_inv_plain(pe10, d10, bi10),
               (3 * C8 + 1) * Mw10 * 4 * fr.NL, 2 * C8 * Mw10, reps=20, keep=False,
               label=f"chain_bwd_inv Fr C={C8} Mw={Mw10}", mul_ops=FR_MUL_OPS)
        print(f"chain_bwd_inv Fr C={C8} Mw={Mw10}: device {device_ms(torch, k10, 20)} ms",
              flush=True)
    fp_inv_ops = inv_batches(F.p_int)[3]
    for n9 in (512, 16, 1):
        x9 = bp[:, :n9].contiguous()
        record("fermat_inv", (aff.fermat_inv(x9),), (aff._fermat_inv_plain(x9),),
               lambda: aff.fermat_inv(x9), lambda: aff._fermat_inv_plain(x9),
               2 * n9 * FE_BYTES, n9, reps=10, label=f"fermat_inv n={n9}", keep=n9 == 512,
               mul_ops=fp_inv_ops)
    # K9 over Fr at what proving hands it (recorded from compute_kzg_proof:
    # eval_at's 4,096 denominators chained to 512 lanes, the quotient's one
    # lane), and over Fp and Fr at 0, 1 and p - 1
    afr = fr.affine
    fr_inv_ops = inv_batches(fr.p_int)[3]
    fr_calls = record_calls(afr, "fermat_inv", lambda: eip4844.compute_kzg_proof(
        blobs["dense1"], zs["off"], kzg))
    check([x.shape[1] for (x,) in fr_calls] == [512, 1],
          f"compute_kzg_proof: Fr fermat_inv calls at {[x.shape for (x,) in fr_calls]}")
    for (x9,) in fr_calls:
        n9 = x9.shape[1]
        record("fermat_inv", (afr.fermat_inv(x9),), (afr._fermat_inv_plain(x9),),
               lambda: afr.fermat_inv(x9), lambda: afr._fermat_inv_plain(x9),
               2 * n9 * 4 * fr.NL, n9, reps=10, label=f"fermat_inv Fr n={n9} (prove)",
               mul_ops=fr_inv_ops, keep=False)
    x16 = fr_calls[0][0][:, :16].contiguous()
    same((afr.fermat_inv(x16),), (afr._fermat_inv_plain(x16),), "fermat_inv Fr n=16")
    for field in (F, fr):
        m = field.p_int
        x9 = field.encode([0, 1, m - 1], dev).T.contiguous()
        got9 = field.affine.fermat_inv(x9)
        same((got9,), (field.affine._fermat_inv_plain(x9),), f"fermat_inv {field.name} 0, 1, p - 1")
        check(field.decode(got9.T) == [0, 1, m - 1], f"fermat_inv {field.name}: 0, 1, p - 1")
        steps, bits, batches, ops = inv_batches(m)
        print(f"fermat_inv {field.name}: exact at 0, 1 and p - 1; safegcd {steps} divsteps "
              f"(Bernstein-Yang's bound for {m.bit_length()} bits), {batches} batches of {bits}, "
              f"{ops} word operations a lane (the bound's count)", flush=True)

    # K13 at the single verify's 2 lanes (commitment, proof), the batch's 128
    # and the cell verify's 130 (two commitments and 128 proofs)
    k13_lane = k13_muls(ctx.p, ctx.params.x_param)
    for data, keep in ((C1 + P1, True), (b"".join(bcs) + b"".join(bps), False),
                       (C1g + C2g + b"".join(proofs[1]), False)):
        x13, s13, _, _ = parse_g1_host(data)
        xm13 = F.to_mont(lb.to_tensor(x13, dev))
        sg13 = torch.as_tensor(s13, device=dev)
        n13 = xm13.shape[0]
        record("g1_decompress", k13(g1d, xm13, sg13), k13(g1d, xm13, sg13, plain=True),
               lambda: g1d.decompress_mont(xm13, sg13),
               lambda: g1d._decompress_plain(xm13, sg13.bool()),
               n13 * (2 * FE_BYTES + 8), n13 * k13_lane, reps=5,
               label=f"g1_decompress n={n13}", keep=keep)

    # K11 at the single verify's 2 pairs and at 256 random pairs (bench.py's
    # bls12381_pairing_batch256: [k]G1 and [k']G2, k, k' < 2^60 from seed 5);
    # K12 at the verify's one product lane and at the 256 Miller outputs
    # each lane's multiplies for the bound: the programs' products, and K12's
    # inverse (one member's chain)
    progs = {"miller_loop": program_stats(build.library("miller_loop"), "ctt_miller_loop_stats",
                                          eng._consts),
             "final_exp": program_stats(build.library("final_exp"), "ctt_final_exp_stats",
                                        eng._consts)}
    mil_lane = progs["miller_loop"]["products"]
    fexp_lane = progs["final_exp"]["products"] + progs["final_exp"]["inverse multiplies"]
    v = get_verifier(kzg)
    cpar, ppar = parse_g1_host(C1), parse_g1_host(P1)
    (xv, yv), _ = v.decompress(np.concatenate([cpar[0], ppar[0]]),
                               np.concatenate([cpar[1], ppar[1]]),
                               np.concatenate([cpar[2], ppar[2]]))
    no_inf = torch.zeros(1, dtype=torch.bool, device=dev)
    Pv, Qv, _ = v.core_pairs((xv[:1], yv[:1]), no_inf, (xv[1:], yv[1:]), no_inf,
                             lb.to_tensor(lb.int_to_limbs(int.from_bytes(zs["off"], "big"), 8),
                                          dev),
                             lb.to_tensor(lb.int_to_limbs(int.from_bytes(y1, "big"), 8), dev))
    prng = np.random.default_rng(5)
    g1s = [rm.ec_mul(int(k), ctx.g, 0, ctx.p) for k in prng.integers(2, 2 ** 60, size=256)]
    g2s = [rm.ec2_mul(int(k), ctx.g2_aff, (0, 0), -1, ctx.p)
           for k in prng.integers(2, 2 ** 60, size=256)]
    P256 = (F.encode([q[0] for q in g1s], dev), F.encode([q[1] for q in g1s], dev))
    Q256 = tuple(F.encode([c for q in g2s for c in q[i]], dev).reshape(256, 2, NL)
                 for i in (0, 1))
    for (Pm, Qm), keep in (((Pv, Qv), True), ((P256, Q256), False)):
        nm = Pm[0].shape[0]
        record("miller_loop", (eng.miller_loop(Pm, Qm),), (eng._miller_loop_plain(*Pm, *Qm),),
               lambda: eng.miller_loop(Pm, Qm), lambda: eng._miller_loop_plain(*Pm, *Qm),
               nm * (2 * FE_BYTES + 4 * FE_BYTES + 12 * FE_BYTES), nm * mil_lane, reps=3,
               label=f"miller_loop B={nm}", keep=keep)
    fv = eng.miller_loop(Pv, Qv)
    f1 = p12.mul(fv[:1], fv[1:])                      # multi_pairing's product
    f256 = eng.miller_loop(P256, Q256)
    for fm, keep in ((f1, True), (f256, False)):
        nf = fm.shape[0]
        record("final_exp", (eng.final_exp(fm),), (eng._final_exp_plain(fm),),
               lambda: eng.final_exp(fm), lambda: eng._final_exp_plain(fm),
               nf * 24 * FE_BYTES, nf * fexp_lane, reps=3, label=f"final_exp B={nf}",
               keep=keep)
    check(bool(p12.eq(eng.final_exp(f1), p12.one((1,), dev)).all()),
          "the verify's pairing product is not one")
    # the chain floor: (rounds with a product + the inverse's lone
    # multiplies) x one fe_mul_eo's latency in a lone thread's chain
    lat_us, exact, _ = mul_latency(ctypes.CDLL(str(chain_src.with_suffix(".so"))), ctx, dev,
                                   True)
    check(exact, "the fe_mul_eo chain differs from the plain product")
    print(f"fe_mul_eo: {lat_us:.4f} us a multiply in a lone thread's dependent chain "
          "(CUDA events)", flush=True)
    for name, st in progs.items():
        floor_ms = (st["product rounds"] + st["inverse multiplies"]) * lat_us * 1e-3
        print(f"{name} program: " + ", ".join(f"{k} {v}" for k, v in st.items())
              + f"; chain floor {floor_ms:.4f} ms; kernel {report[name]['ms']:.4f} ms at the "
              f"verify's B = {1 if name == 'final_exp' else 2}, "
              f"{report[name]['ms'] / floor_ms:.2f}x the floor", flush=True)
    for (W7, c7), ms7 in k7_ms.items():
        floor7 = 3 * c7 * (W7 - 1) * lat_us * 1e-3
        print(f"scaled_doubles W={W7} c={c7}: longest lane {c7 * (W7 - 1)} doublings of 3 "
              f"rounds; chain floor {floor7:.4f} ms; kernel {ms7:.4f} ms, {ms7 / floor7:.2f}x "
              "the floor", flush=True)
    for (n3, k3), (ms3, dms3) in dk_ms.items():
        floor3 = 3 * k3 * lat_us * 1e-3
        print(f"ec_double_k n={n3} k={k3}: {k3} doublings of 3 rounds; chain floor "
              f"{floor3:.4f} ms; kernel {ms3:.4f} ms a call (CUDA events), device "
              + ("not measured" if dms3 is None else
                 f"{dms3:.4f} ms a launch (CUDA events, queued behind a sleep), "
                 f"{dms3 / floor3:.2f}x the floor"), flush=True)
    for (T6, lanes6), ms6 in k6_ms.items():
        floor6 = 5 * (T6 - 1) * lat_us * 1e-3
        dms = device_ms(torch, lambda: pec.bucket_reduce(*k6_in[T6, lanes6], T6), 20)
        print(f"bucket_reduce T={T6} lanes={lanes6}: T - 1 steps with an add of 5 rounds; chain "
              f"floor {floor6:.4f} ms; kernel {ms6:.4f} ms a call (CUDA events), "
              f"{ms6 / floor6:.2f}x the floor; device "
              + ("not measured" if dms is None else
                 f"{dms:.4f} ms a launch (CUDA events, queued behind a sleep), "
                 f"{dms / floor6:.2f}x the floor"),
              flush=True)
    k13_steps = k13_chain(ctx.p, ctx.params.x_param)
    floor13 = k13_steps * lat_us * 1e-3
    print(f"g1_decompress lane: {k13_lane} multiplies, {k13_steps} of them dependent for a team "
          f"of 4; chain floor {floor13:.4f} ms, bound {report['g1_decompress']['bound_ms']:.6f} "
          f"ms; kernel {report['g1_decompress']['ms']:.4f} ms at the verify's 2 lanes, "
          f"{report['g1_decompress']['ms'] / floor13:.2f}x the floor", flush=True)
    # K3' ntt_bfly at every stage of the paths' transforms, each stage's
    # input the transform's own: the blob's 4096 iNTT and its 8192 extension
    # NTT (the four-step's column and row stages), the FK20 NTT over (64,
    # 128) and the verify's cell iNTT over (128, 64) (radix-2); the column
    # pass's store factor (the twiddle matrix, transposed) against K1's plain
    # product after the per-stage route. ntt_bfly's and ntt_stages' rows of
    # the kernels' line come from the passes below.
    def check_stages(label, y, tws, brp):
        y = y.index_select(1, brp)
        for st, tw in enumerate(tws):
            h = 1 << st
            got = ntt_bfly(fr, y, tw, h)
            same((got,), (ntt_bfly_plain(fr, y, tw, h),), f"ntt_bfly {label} h={h}")
            y = got
        return y

    def stage_work(y, stages, kw):
        """Bytes (y in, out, the twiddles, the factor tables) and multiplies
        (the stages', a factor's one an element) of a pass over y."""
        facs = [f for f in (kw.get("in_fac"), kw.get("out_fac")) if f is not None]
        return (2 * y.numel() * 4 + ((1 << stages) - 1) * 4 * fr.NL
                + sum(f.numel() * 4 for f in facs),
                stages * y.numel() // (2 * fr.NL) + len(facs) * y.numel() // fr.NL)

    dom12 = get_domain("BLS12_381", 12)
    coeffs = das._blob_to_coeffs(blobs["dense1"])
    evals = fr.to_mont(lb.to_tensor(eip4844.blob_to_polynomial(blobs["dense1"])[0], dev))
    evals = evals.index_select(0, torch.as_tensor(brp12, device=dev))
    for label, dom, x, inverse in (("4096 iNTT", dom12, evals, True),
                                   ("8192 NTT", dom13, torch.cat([coeffs, torch.zeros_like(
                                       coeffs)]), False)):
        n1, n2, twm = dom._four_step_tables(inverse, dev)
        tws = dom.twiddles(inverse, dev)
        brp1 = torch.as_tensor(bit_reversal_perm(n1), device=dev)
        y = check_stages(f"{label} columns (1, {n1}, {n2})", x.reshape(1, n1, n2, fr.NL),
                         tws[:n1.bit_length() - 1], brp1)
        col = ntt_stages(fr, x.reshape(1, n1, n2, fr.NL), dom.packed_twiddles(inverse, dev),
                         brp1, n1.bit_length() - 1, out_fac=twm, transposed=True)
        same((col,), (mont_mul_plain(y.transpose(1, 2).contiguous(),
                                     twm.reshape(1, n2, n1, fr.NL), fr),),
             f"{label}: the column pass's store factor against K1's plain twiddle product")
        y = check_stages(f"{label} rows (1, {n2}, {n1})", col, tws[:n2.bit_length() - 1],
                         torch.as_tensor(bit_reversal_perm(n2), device=dev))
        y = y.reshape(-1, fr.NL)
        y = mont_mul_plain(y, dom.n_inv(dev).expand_as(y), fr) if inverse else y
        check(torch.equal(y, dom.intt(x) if inverse else dom.ntt(x)),
              f"{label}: stages do not compose to the transform")
    circ = coeffs.index_select(0, das._circ_idx).reshape(64, 128, fr.NL)
    circ = torch.where(das._circ_mask[..., None], circ, torch.zeros_like(circ))
    cell_evals = fr.to_mont(lb.to_tensor(np.concatenate(
        [scalars_from_bytes(c)[0] for c in cells[1]]), dev)).reshape(128, 64, fr.NL)
    for label, dom, x, inverse in (("FK20 NTT (64, 128, 1)", das.dom_cds, circ, False),
                                   ("cell iNTT (128, 64, 1)", das.dom_cell, cell_evals, True)):
        check_stages(label, x.reshape(x.shape[0], dom.n, 1, fr.NL), dom.twiddles(inverse, dev),
                     torch.as_tensor(bit_reversal_perm(dom.n), device=dev))
    print("check ntt_bfly at every stage of the four-step, FK20 and cell transforms, and the "
          "column pass's store factor against K1's plain product: exact", flush=True)

    # K3' ntt_stages at every pass the PeerDAS paths run, with its factors
    # and store as the paths give them (recorded from the entry points), and
    # each of those shapes at every combination of the factors and the
    # store; ntt_bfly at the 2^16 radix-2 route's stages (its only caller).
    # Kept in the kernels' line: the 8192 NTT's column pass (1, 64, 128),
    # the twiddle matrix on its store, transposed.
    pass_calls = (
        ("cells", lambda: peerdas.compute_cells(blobs["dense1"], das_cells)),
        ("cells and proofs", lambda: peerdas.compute_cells_and_kzg_proofs(blobs["dense1"], das)),
        ("verify cells", lambda: peerdas.verify_cell_kzg_proof_batch(*all1, das)),
        ("recover", lambda: peerdas.recover_cells_and_kzg_proofs(
            half_idx, [cells[1][i] for i in half_idx], das)))
    passes, bflys = {}, {}
    for label, fn in pass_calls:
        for (F_, y, tw, brp_, stages), kw in record_calls(ntt_mod, "ntt_stages", fn, True):
            passes.setdefault((*y.shape[:3], stages, variant_name(kw)), (label, y, tw, brp_, kw))
    for (F_, y, tw, h), _ in record_calls(ntt_mod, "ntt_bfly", lambda: dom16.ntt(xn16[None]),
                                          True):
        bflys.setdefault((*y.shape[:3], h), ("2^16 radix-2", y, tw))
    for (B, ns, lanes, stages, vname), (label, y, tw, brp_, kw) in passes.items():
        record("ntt_stages", (ntt_stages(fr, y, tw, brp_, stages, **kw),),
               (ntt_stages_plain(fr, y, tw, brp_, stages, **kw),),
               lambda: ntt_stages(fr, y, tw, brp_, stages, **kw),
               lambda: ntt_stages_plain(fr, y, tw, brp_, stages, **kw),
               *stage_work(y, stages, kw), reps=50,
               label=f"ntt_stages {label} ({B}, {ns}, {lanes}), {stages} stages, {vname}",
               mul_ops=FR_MUL_OPS,
               keep=(B, ns, lanes, vname) == (1, 64, 128, "in - out p8192 transposed"))
    nvar = 0
    for (B, ns, lanes, stages) in dict.fromkeys(k[:4] for k in passes):
        label, y, tw, brp_, _ = next(v for k, v in passes.items() if k[:4] == (B, ns, lanes,
                                                                               stages))
        for kw in pass_variants(y):
            same((ntt_stages(fr, y, tw, brp_, stages, **kw),),
                 (ntt_stages_plain(fr, y, tw, brp_, stages, **kw),),
                 f"ntt_stages ({B}, {ns}, {lanes}) {variant_name(kw)}")
            nvar += 1
    print(f"check ntt_stages at every pass shape of paths i-l with every combination of the "
          f"factors and the store ({nvar} launches): exact", flush=True)
    check(bflys, "ntt 2^16: no ntt_bfly call recorded on the radix-2 route")
    for (B, ns, lanes, h), (label, y, tw) in bflys.items():
        record("ntt_bfly", (ntt_bfly(fr, y, tw, h),), (ntt_bfly_plain(fr, y, tw, h),),
               lambda: ntt_bfly(fr, y, tw, h), lambda: ntt_bfly_plain(fr, y, tw, h),
               2 * y.numel() * 4 + h * 4 * fr.NL, y.numel() // (2 * fr.NL), reps=50,
               label=f"ntt_bfly {label} ({B}, {ns}, {lanes}) h={h}", mul_ops=FR_MUL_OPS,
               keep=h == 1 << 15)
    for (B, ns, lanes, stages, vname), (label, y, tw, brp_, kw) in passes.items():
        dms = device_ms(torch, lambda: ntt_stages(fr, y, tw, brp_, stages, **kw), 20)
        print(f"ntt_stages ({B}, {ns}, {lanes}), {stages} stages, {vname}: device "
              f"{'not measured' if dms is None else f'{dms:.4f} ms'} a launch (CUDA events, "
              "queued behind a sleep)", flush=True)
    for label, fn in (("ntt 2^16 four-step", lambda: dom16.ntt(xn16)),
                      ("intt 2^16 four-step", lambda: dom16.intt(xn16)),
                      ("ntt 2^16 radix-2 (a batch of one)", lambda: dom16.ntt(xn16[None])),
                      ("intt 2^16 radix-2 (a batch of one)", lambda: dom16.intt(xn16[None]))):
        dms = device_ms(torch, fn, 20)
        print(f"{label}: {cuda_ms(torch, fn, 20):.4f} ms a call (CUDA events), device "
              f"{'not measured' if dms is None else f'{dms:.4f} ms'} a call (queued behind a "
              "sleep)", flush=True)

    # ec_scalar_mul over 255 bits, inputs from this run's FK20: at 64 lanes
    # (an EC-FFT stage's width) against the plain ladder, on bank points with
    # k = 0, 1, r - 1, r (its last add is D + (-D)), r + 2 (its last add
    # doubles) and a point at infinity among seeded scalars; against the
    # plain ladder also at the main path's other shapes: 1/n over 128 bank
    # points, a bank stage (its 64 twiddles over 64 columns, 4,096 lanes)
    # and the Hadamard product (the NTT's 8,192 scalars times the bank);
    # against the per-bit K3 composition (double, add, select) at the
    # inverse EC-FFT's last stage (its 64 twiddles, 64 bank points) and at
    # the Hadamard product; timed at 64, 128, 4,096 and 8,192 lanes beside
    # the composition at 64.
    def k3_ladder(k, P, nbits):
        kw = lb.widen(k)
        idx = torch.arange(nbits - 1, -1, -1, device=dev)
        bits = ((kw[idx // 32] >> (idx % 32)[:, None]) & 1).bool()
        one = F.broadcast_one((k.shape[1],), dev).T.contiguous()
        acc = (one, one.clone(), torch.zeros_like(one))
        for bit in bits:
            acc = pec.double(acc)
            added = pec.add(acc, P)
            acc = tuple(torch.where(bit, a2, a1) for a2, a1 in zip(added, acc))
        return acc

    bankp = tuple(t.reshape(-1, NL).T.contiguous() for t in das.bank)          # (NL, 8192)
    w_had = fr.from_mont(das.dom_cds.ntt(circ)).reshape(-1, fr.NL).T.contiguous()
    srng = np.random.default_rng(64)
    ks64 = [0, 1, r - 1, r, r + 2] + [int.from_bytes(srng.bytes(32), "big") >> 1
                                      for _ in range(59)]
    k64 = lb.to_tensor(lb.ints_to_limbs(ks64, fr.NL), dev).T.contiguous()
    P64 = tuple(v[:, :64].clone() for v in bankp)
    P64[2][:, 5] = 0

    # K3 add at FK20's widths (64 and 128 lanes) on bank points: lane 0 P + P,
    # lane 1 P + (-P), lane 2 inf + Q, lane 3 P + inf
    for n in (64, 128):
        Pf = tuple(v[:, :n].T.contiguous() for v in bankp)
        Qf = tuple(v[:, n:2 * n].T.contiguous() for v in bankp)
        for v, w in zip(Qf, Pf):
            v[:2] = w[:2]
        Qf[1][1] = F.neg(Pf[1][1][None])[0]
        Pf[2][2] = 0
        Qf[2][3] = 0
        Pfp, Qfp = planar(Pf), planar(Qf)
        got_f = pec.add(Pfp, Qfp)
        same(got_f, planar(ec_add(F, mul_plain, Pf, Qf)), f"ec_add FK20 n={n}")
        check(g.is_inf(std(got_f))[:4].tolist() == [False, True, False, False],
              f"ec_add FK20 n={n}: degenerate lanes")
        add_times(f"{n} lanes (FK20)", Pfp, Qfp, cuda_ms(torch, lambda: pec.add(Pfp, Qfp), 50))
    print("check ec_add against the plain version at FK20's 64 and 128 lanes: exact",
          flush=True)

    def ladder_work(n):
        """Bytes (points and scalars in, points out) and multiplies of n lanes,
        two of a lane's for its point's Z^2 and Z^3."""
        return n * (6 * FE_BYTES + 4 * fr.NL), n * (LADDER_MULS * 255 + 2)

    got64 = pec.scalar_mul(k64, P64, 255)
    record("ec_scalar_mul", got64, pec._scalar_mul_plain(k64, P64, 255),
           lambda: pec.scalar_mul(k64, P64, 255), lambda: pec._scalar_mul_plain(k64, P64, 255),
           *ladder_work(64), reps=20, label="ec_scalar_mul 64 lanes x 255 bits (degenerate lanes)")
    lanes64 = [affine(tuple(v[i] for v in std(got64))) for i in range(6)]
    p1, p2, p4 = (affine(tuple(v[i] for v in std(P64))) for i in (1, 2, 4))
    check(lanes64 == [None, p1, rm.ec_neg(p2, ctx.p), None, rm.ec_mul(2, p4, 0, ctx.p), None],
          "ec_scalar_mul: [0]P, [1]P, [r-1]P, [r]P, [r+2]P, [k]inf")
    tws, n_inv, _ = das.ec_cds._tables(dev)
    kst = tws[True][-1].T.contiguous()
    Pst = tuple(v[:, 64:128].contiguous() for v in bankp)
    for label, kn, Pn in (
            ("1/n (128 lanes)", n_inv[:, None].expand(-1, 128).contiguous(),
             tuple(v[:, 128:256].contiguous() for v in bankp)),
            ("bank stage (4,096 lanes)", tws[False][-1].T.repeat_interleave(64, 1).contiguous(),
             tuple(v[:, :4096].contiguous() for v in bankp)),
            ("FK20 Hadamard (8,192 lanes)", w_had, bankp)):
        same(pec.scalar_mul(kn, Pn, 255), pec._scalar_mul_plain(kn, Pn, 255),
             f"ec_scalar_mul against the plain ladder, {label}")
    print("check ec_scalar_mul against the plain ladder at 128, 4,096 and 8,192 lanes: exact",
          flush=True)
    same(pec.scalar_mul(kst, Pst, 255), k3_ladder(kst, Pst, 255),
         "ec_scalar_mul against the K3 composition, EC-FFT stage (64 lanes)")
    same(pec.scalar_mul(w_had, bankp, 255), k3_ladder(w_had, bankp, 255),
         "ec_scalar_mul against the K3 composition, FK20 Hadamard (8,192 lanes)")
    print("check ec_scalar_mul against the K3 composition at 64 and 8,192 lanes: exact",
          flush=True)
    sm_ms = {64: report["ec_scalar_mul"]["ms"]}
    for n in (128, 4096, 8192):
        kn, Pn = w_had[:, :n].contiguous(), tuple(v[:, :n].contiguous() for v in bankp)
        sm_ms[n] = cuda_ms(torch, lambda: pec.scalar_mul(kn, Pn, 255), 5)
    k3_ms = cuda_ms(torch, lambda: k3_ladder(kst, Pst, 255), 3)
    for n, ms in sm_ms.items():
        bms, by = bound(*ladder_work(n))
        print(f"ec_scalar_mul {n} lanes x 255 bits: {ms:.4f} ms a call (CUDA events), bound "
              f"{bms:.6f} ms ({by})", flush=True)
    print(f"the per-bit K3 composition it replaces, 64 lanes x 255 bits: {k3_ms:.4f} ms a call "
          f"(CUDA events)", flush=True)

    t0 = time.perf_counter()
    r_kernels = r_inputs.check(same, plain_add, plain_double_k)
    r_check_s = time.perf_counter() - t0
    print(f"path r's kernels against their plain versions: {r_check_s:.1f} s", flush=True)
    print(f"path r took {r_s + r_check_s:.1f} s (its calls {r_s:.1f} s, its kernels against "
          f"their plain versions {r_check_s:.1f} s); the cuts to paths n-q saved {freed_s:.1f} s "
          f"({'within' if r_s + r_check_s <= freed_s else 'above'} it)", flush=True)
    check(r_kernels >= set(PATH_KERNELS["eip2537"]),
          f"path r's kernels not checked at its shapes: {set(PATH_KERNELS['eip2537']) - r_kernels}")
    pair_ms = cuda_ms(torch, lambda: pr.pairing(P256, Q256), 3)
    print(f"pairing B=256 (K11 + K12): {pair_ms:.3f} ms, {256e3 / pair_ms:.3f} pairings/s",
          flush=True)

    kernels = []
    for name in build.KERNELS:
        src, rep = REPLACES[name]
        kernels.append(dict(name=name, route="cuda", source=src, replaces=rep,
                            launches=total[name], library_ms=None, **report[name]))
    group_done("the kernels against their plain versions, timed")
    print(f"seconds: the smoke in all {time.perf_counter() - t_main:.1f} s", flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as e:
        print(f"FAILED: {e}", file=sys.stderr)
        sys.exit(1)
