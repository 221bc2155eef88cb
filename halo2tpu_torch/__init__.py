"""halo2tpu_torch — the halo2tpu prover ported to PyTorch and CUDA.

The prover's main path (create_proof through TorchEngine) runs on torch
tensors; the four TPU kernels on that path are hand-written CUDA kernels for
Hopper (sm_90a) in csrc/, built with nvcc at first use (_build.py).  On CPU
tensors every kernel wrapper runs its plain torch version instead.

Host layers with no JAX in them (circuits, gadgets, circuit IR, transcript,
SHPLONK, verifier, SRS, host curve/field code) are imported from halo2tpu;
this package never imports jax.  Module paths mirror halo2tpu's:
  fields/jfield    limb tensors, Montgomery Fr/Fq arithmetic
  curves/jpoint    batched Jacobian G1 formulas (plain reference)
  ops/cuda_field   mont_mul kernel + plain version
  ops/cuda_ec      fold_mixed / fold_add_any / fold_dbl_any kernels + plain
  ops/ntt, ops/msm radix-2 NTT, windowed fixed-base MSM
  plonk/           TorchEngine, quotient, keygen, create_proof
  convert          halo2tpu (JAX) arrays <-> port tensors
"""

__version__ = "0.1.0"
