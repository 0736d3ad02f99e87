"""PyTorch and CUDA port of ``constantine_tpu`` for NVIDIA Hopper (sm_90a).

The JAX package beside this one is the reference. Module and function names
follow it, so ``constantine_tpu_torch.ops.msm_gpu._sorted_stream`` is the
counterpart of ``constantine_tpu.ops.msm_tpu._sorted_stream``.

Layout: a field element is an ``int32`` tensor of shape ``(..., NL)`` holding
the bit patterns of NL little-endian 32-bit limbs (12 for BLS12-381 Fp, 8 for
Fr), in Montgomery form with the reference's R (2^384 and 2^256). Two 16-bit
digits of the reference are one 32-bit limb here, so the Montgomery values are
bit-identical between the two packages (see ``convert.py``).

Every Pallas kernel on the ported path is a hand-written CUDA C++ kernel under
``csrc/``, built with nvcc at first use (``build.py``). A tensor on the CPU
takes the kernel's plain PyTorch version; a CUDA tensor launches the kernel.
Entry points default to ``device="cuda"``.
"""
