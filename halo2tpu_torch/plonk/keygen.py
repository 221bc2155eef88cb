"""Keygen through the TorchEngine.

halo2tpu/plonk/keygen.py::keygen imports halo2tpu/fields/jfield.py, which
imports jax, so this module carries its own thin keygen: the key classes,
the permutation mapping and the vk digest rule are halo2tpu's, the field
packing is the port's numpy helper, and the fixed and sigma commitments run
through TorchEngine.  The pk and vk equal halo2tpu's for the same circuit.
"""
from __future__ import annotations

import os

from halo2tpu.fields.bn254 import R, to_bytes_be
from halo2tpu.ops.keccak import keccak256
from halo2tpu.plonk.circuit import Assignment, ConstraintSystem
from halo2tpu.plonk.domain import make_domain
from halo2tpu.plonk.keygen import (ProvingKey, VerifyingKey,
                                   build_permutation_mapping,
                                   cs_structure_digest, load_proving_key,
                                   save_proving_key)
from halo2tpu.utils.trace import NULL
from ..fields.jfield import ints_to_limbs16
from .engine import TorchEngine


def keygen(circuit, k: int, srs, device="cpu", tracer=None):
    """(pk, vk) for `circuit` at 2^k rows, the commitments made by a
    TorchEngine on `device`."""
    tr = tracer or NULL
    cs = ConstraintSystem()
    config = circuit.configure(cs)
    n = 1 << k
    assert srs.n >= n, "SRS too small for circuit"
    assert cs.usable_rows(n) >= 1

    domain = make_domain(k, cs.degree())
    engine = TorchEngine(domain, srs, device)

    with tr.phase("kg_synthesize"):
        asn = Assignment(cs, n)
        circuit.synthesize(config, asn)

    with tr.phase("kg_sigmas"):
        fixed_values = [ints_to_limbs16([int(v) % R for v in col])
                        for col in asn.fixed]
        perm_mapping = build_permutation_mapping(cs, n, asn.copies)

    with tr.phase("kg_encode"):
        fixed_dev = engine.from_packed_stack(fixed_values)
        sigma_dev = engine.sigma_from_mapping(perm_mapping)
    with tr.phase("kg_commit"):
        fixed_commitments = engine.commit_lagrange_batch(fixed_dev)
        sigma_commitments = engine.commit_lagrange_batch(sigma_dev)

    instances = circuit.instances()
    num_instance_rows = [len(col) for col in instances]

    # vk digest: halo2tpu's canonical serialization -> keccak
    h = bytearray()
    h += k.to_bytes(4, "big")
    h += cs.num_advice.to_bytes(4, "big")
    h += cs.num_fixed.to_bytes(4, "big")
    h += cs.num_instance.to_bytes(4, "big")
    for c in fixed_commitments + sigma_commitments:
        if c is None:
            h += b"\x00" * 64
        else:
            h += to_bytes_be(c[0]) + to_bytes_be(c[1])
    transcript_repr = int.from_bytes(keccak256(bytes(h)), "big") % R

    vk = VerifyingKey(
        k=k, n=n, domain=domain, cs=cs,
        fixed_commitments=fixed_commitments,
        permutation_commitments=sigma_commitments,
        transcript_repr=transcript_repr,
        num_instance_rows=num_instance_rows,
    )
    pk = ProvingKey(vk=vk, fixed_values=fixed_values,
                    perm_mapping=perm_mapping, config=config)
    return pk, vk


def keygen_cached(circuit, k: int, srs, cache_key: str, device="cpu",
                  cache_dir: str | None = None, tracer=None):
    """keygen with on-disk pk persistence (halo2tpu's pickle format and
    file name), keyed by cache_key and the circuit's structure digest."""
    cache_dir = cache_dir or os.path.join(
        os.path.dirname(__file__), "..", "..", ".cache")
    os.makedirs(cache_dir, exist_ok=True)
    digest = cs_structure_digest(circuit)
    path = os.path.join(cache_dir, f"pk3_{cache_key}_{digest}_k{k}.pkl")
    if os.path.exists(path):
        pk = load_proving_key(path)
        return pk, pk.vk
    pk, vk = keygen(circuit, k, srs, device=device, tracer=tracer)
    tmp = f"{path}.{os.getpid()}.tmp"
    save_proving_key(pk, tmp)
    os.replace(tmp, path)
    return pk, vk
