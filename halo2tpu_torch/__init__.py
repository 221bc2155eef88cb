"""halo2tpu_torch — the halo2tpu prover ported to PyTorch and CUDA.

The prover's main path (create_proof through TorchEngine) and the
bit-serial MSM (ops/msm.py::msm) run on torch tensors; every TPU kernel is
a hand-written CUDA kernel for Hopper (sm_90a) in csrc/, built with nvcc at
first use (_build.py).  On CPU tensors every kernel wrapper runs its plain
torch version instead.

The package stands alone: it imports torch, never jax and nothing of
halo2tpu.  The host layers it needs (BN254 host field and curve code, the
pure-Python keccak, circuit IR, domain, polyops, transcript, SHPLONK, SRS,
the key layer, verifier, gadgets and circuits) are copies of halo2tpu's at
the mirrored paths, so a reader finds each counterpart.  Entry points run
on the CUDA device unless the caller passes device="cpu".
  fields/jfield    limb tensors, Montgomery Fr/Fq arithmetic
  curves/jpoint    batched Jacobian G1 formulas (plain reference)
  ops/cuda_field   mont_mul kernel + plain version
  ops/cuda_ec      fold_mixed / fold_mixed_tiled / fold_add / fold_add_any /
                   fold_dbl_any kernels + plain versions
  ops/ntt, ops/msm radix-2 NTT, windowed fixed-base MSM, bit-serial msm()
  plonk/           TorchEngine, quotient, keygen, create_proof, verifier
  convert          halo2tpu (JAX) arrays <-> port tensors
"""

__version__ = "0.1.0"
